"""Analytic FLOP, byte and FP32-slot counts of a step and its roofline
against the H100's datasheet peaks (the counterpart of
``repro/roofline``)."""
