"""Parallel and streaming front ends of the port. Ported so far: the
single-device pixel stream (`parallel.stream`)."""
