"""The plain reference that decides ``correct``: k-mer classes and
pseudoalignment (``kmers.py``), the fragment-length estimate (``fld.py``)
and EM (``em.py``) in plain PyTorch, run on the card or the CPU.

It is written from the semantics the program states (kallisto-style
pseudoalignment: a read's equivalence class is the intersection of the
transcript sets of its k-mers; EM over equivalence-class counts) and
imports nothing of the program. It takes the transcript sequences and the
reads that the benchmark made and works everything else out again.
"""
