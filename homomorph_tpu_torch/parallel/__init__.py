"""Scale-out on ``torch.distributed``: grids of places, sharded bulk
encrypt/decrypt, limb-sharded clmul and multi-process orchestration
(counterpart of :mod:`homomorph_tpu.parallel`)."""

from . import bulk, distributed, limbmul, mesh  # noqa: F401
from .bulk import sharded_decrypt_bits, sharded_encrypt_bits, sharded_gate_xor  # noqa: F401
from .limbmul import (  # noqa: F401
    comm_bytes_per_call,
    get_default_limb_mesh,
    maybe_sharded_clmul,
    set_default_limb_mesh,
    sharded_clmul,
    use_limb_mesh,
)
from .mesh import Mesh, Place, ShardingConfig, make_mesh, ppermute  # noqa: F401
