"""Host-side HERO layer of the port: RAB + paged KV pool, backing store,
event tracing."""
