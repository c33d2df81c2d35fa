"""Export of trained submodules into ``saved model/`` (counterpart of
``py_psnode_tpu/export``): ``.pt2`` programs, weight snapshots, the flat
binary of the C++ runtime, and that runtime's binding."""

from py_psnode_tpu_torch.export.artifacts import (  # noqa: F401
    export_submodule,
    flatten_channelwise,
    flatten_params,
    write_dim_txt,
)
from py_psnode_tpu_torch.export.binfmt import read_weights_bin, write_weights_bin  # noqa: F401
