"""The benchmark of ``microbeseg_torch`` on one NVIDIA H100 (see ``run.py``)."""
