"""Applications of the port: the machine-translation app."""
