"""The threaded real-time runtime of the port (queues, pipeline)."""
