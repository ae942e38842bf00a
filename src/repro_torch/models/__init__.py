"""Models of the port (the LM family with its mixture of experts, and the
recsys models) and their config dataclasses."""
