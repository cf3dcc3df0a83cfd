"""Operator tools of the port that run the library end to end.

- :mod:`.chaos_soak`: the port's counterpart of ``tools/chaos_soak.py``:
  a mixed workload under a seeded multi-site chaos schedule, held
  against its fault-free run (``python -m
  tensorframes_tpu_torch.tools.chaos_soak --help``).
"""
