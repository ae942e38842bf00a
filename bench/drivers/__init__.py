"""The drivers: what runs a traffic mix through the program. A traffic
file names its driver; a driver's `Run` sets the cell up, runs one unit
of work at a time for the window, and judges what the window's program
produced against the reference."""
