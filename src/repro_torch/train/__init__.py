"""Train and serve steps, checkpoints, fault tolerance and FINGER
telemetry."""
