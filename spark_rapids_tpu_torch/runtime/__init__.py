"""Runtime services: the device-memory budget and spill store, and the
OOM retry ladder."""
