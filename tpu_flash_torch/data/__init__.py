"""Data pipelines of the port: the machine-translation corpora, byte-level
BPE and collates (``data.mt``, ``data.bpe``, ``data.deen_corpus``) and the
C++ batch ring (``data.native_loader``)."""
