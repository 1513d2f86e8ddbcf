"""Runtime services: the device-memory budget and spill store, the OOM
retry ladder, fault injection, failure classes and crash dumps, and the
device semaphore."""
