"""Training on one card: AdamW, int8 gradient compression with error
feedback, atomic checkpoints, restarts and the pipeline schedule (the
reference's `training/`)."""
