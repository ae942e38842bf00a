"""Telemetry of the port: the metrics bus, phase spans and the log sink."""
