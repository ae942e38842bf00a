"""Models of the port (SASRec so far) and their config dataclasses."""
