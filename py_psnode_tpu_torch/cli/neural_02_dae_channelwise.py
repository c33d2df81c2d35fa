"""CLI entry for the dae_channelwise variant (the JAX package's cli/neural_02_dae_channelwise.py)."""

from py_psnode_tpu_torch.cli.common import main

if __name__ == "__main__":
    main("dae_channelwise")
