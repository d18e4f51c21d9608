"""python -m armnet_tpu_torch.train: see armnet_tpu_torch/train/cli.py."""

from armnet_tpu_torch.train.cli import main

main()
