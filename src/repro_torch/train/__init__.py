"""Train step, checkpoints, fault tolerance and FINGER telemetry."""
