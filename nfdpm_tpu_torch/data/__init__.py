"""Dataset readers and the batch pipeline (numpy on the host, batches moved
to the device one ahead of the step that uses them)."""
