"""The port's twins of the scripts under ``examples/``: the same flows on
``repro_torch``, run as modules::

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_router --device cuda
  PYTHONPATH=src python -m repro_torch.examples.budget_control
  PYTHONPATH=src python -m repro_torch.examples.train_estimator --device cpu

Without ``--device`` they run on the card.
"""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """The serving twins' one option, the device."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0; 'cpu' "
                         "runs the kernels' plain versions)")
    return ap
