"""The benchmark's fixed measures: published peaks (``peaks.py``), the
least bytes and operations of K2 and A3 (``bounds.py``), and the frozen
single-core CPU baseline (``cpu_baseline.c``, ``baseline.py``)."""
