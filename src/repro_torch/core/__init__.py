"""UpLIF index core of the port: state, host builders, ops, the shell and
the sharded router. Exports what ``repro.core`` exports, under the same
names, plus ``UpLIFConfig``. Importing it builds no kernel."""
from repro_torch.core.types import (  # noqa: F401
    RadixSplineModel,
    BMATState,
    GMMState,
    KEY_MAX,
    TOMBSTONE,
)
from repro_torch.core.state import (  # noqa: F401
    Counters,
    UpLIFState,
    UpLIFStatic,
)
from repro_torch.core.radix_spline import build_radix_spline, rs_predict  # noqa: F401
from repro_torch.core.gmm import fit_gmm, gmm_cdf, gmm_pdf  # noqa: F401
from repro_torch.core.nullifier import nullify  # noqa: F401
from repro_torch.core.bmat import BMAT  # noqa: F401
from repro_torch.core import fops  # noqa: F401
from repro_torch.core.uplif import UpLIF, UpLIFConfig  # noqa: F401
from repro_torch.core.sharded import ShardedUpLIF  # noqa: F401
