"""Mean device ms of the port's ``pairs`` span in the traced views: the
per-slot half of binning (the emission, the tile-key sort, the tile and
group ranges and the records' gather over every slot of the pair pool),
between the CUDA events it records at enter and exit
(``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    return spans.device_ms(r.trace, "pairs")
