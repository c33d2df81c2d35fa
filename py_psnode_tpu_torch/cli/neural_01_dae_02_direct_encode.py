"""CLI entry for the dae_encode variant (ref neural_01_DAE_02_direct_encode.py)."""

from py_psnode_tpu_torch.cli.common import main

if __name__ == "__main__":
    main("dae_encode")
