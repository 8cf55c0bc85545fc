"""Data pipelines of the port: the machine-translation corpora, byte-level
BPE and collates (``data.mt``, ``data.bpe``, ``data.deen_corpus``), the
C++ batch ring (``data.native_loader``) and the 2-D point sets of the
classifier demo (``data.points``)."""
