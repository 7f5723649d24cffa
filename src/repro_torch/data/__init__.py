"""The port's data: the synthetic training batches (`pipeline`) and the
JSON files it carries (goldens, calibration, measured FLOPs)."""
