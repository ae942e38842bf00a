"""Health layer of the port (replica failures so far)."""
