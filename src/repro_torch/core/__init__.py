"""Device-model core of the port: platforms, the batched scenario
engine, offload sizing, the day simulator and day-level DSE."""
