"""End-to-end driver: train the SCOPE estimator for a few hundred steps
(SFT -> GRPO), evaluate predictive quality, save a checkpoint (the twin of
``examples/train_estimator.py``).

This wraps the port's launcher, ``repro_torch.launch.train``; pass --size
100m for a ~100M-parameter backbone or keep the default tiny config, and
--device cpu to train without the card.

  PYTHONPATH=src python -m repro_torch.examples.train_estimator --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_estimator \\
      --size 100m --sft-steps 200
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    sys.exit(main())
