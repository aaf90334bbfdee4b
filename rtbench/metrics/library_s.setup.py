"""Seconds of set-up inside the program's `rtw.setup.library` span
(`_build.load_library`'s first call: the source hash, a build if stale,
the load and the C signatures)."""

from rtbench import program_trace as P


def read(out):
    return P.setup_seconds("rtw.setup.library")
