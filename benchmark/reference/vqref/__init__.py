"""A frozen copy of the port's plain paths: the benchmark's reference.

Copied from the port's scene, render, ops, engine (scene load, settings,
frame loop) and utils modules, with the CUDA kernels taken out: every
kernel wrapper runs its plain PyTorch version (``ops/_backend.py``). It
imports nothing of the port, so a later change to the port does not move
the reference that judges it. Only the benchmark's correctness check
imports it, after the timed window.
"""
