"""Qt GUI of the port (import-gated on PyQt5).

The counterpart of ``microbeseg_tpu/gui``: a thin Qt shell over the port's
headless workers (``client.workers``, ``training.workers``,
``evaluation.evaluator``, ``inference.engine``).  ``gui.app`` imports PyQt5;
``python -m microbeseg_torch.gui.app`` names the headless CLIs when PyQt5 is
missing.
"""
