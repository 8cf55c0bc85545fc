"""Data pipelines of the port: the packed machine-translation collate and
the synthetic translation corpus (``data.mt``)."""
