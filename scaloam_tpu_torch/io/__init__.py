"""Dataset readers and session artifact writers of the port (numpy)."""
