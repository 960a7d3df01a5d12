"""Waiting on the subprocesses a test starts, with a limit of its own."""

import subprocess

import pytest


def communicate_all(procs, limit_s):
    """Each process's ``(stdout, stderr)``, waiting at most ``limit_s`` for
    each; where one outlasts it, kills them all and fails the test with
    what they printed."""
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=limit_s))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        left = procs[len(results):]
        outs = [(out or "") + (err or "")
                for out, err in (p.communicate() for p in left)]
        pytest.fail(f"outlasted {limit_s} s:\n" + "\n".join(outs))
    return results
