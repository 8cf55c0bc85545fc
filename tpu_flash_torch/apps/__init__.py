"""Applications of the port: the machine-translation training core."""
