"""Seconds of set-up inside the program's `rtw.setup.scene` span
(`scene.builder.build_scene`: the scene's compile, its native trees and
the native builder's load)."""

from rtbench import program_trace as P


def read(out):
    return P.setup_seconds("rtw.setup.scene")
