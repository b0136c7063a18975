"""Dense design grids (``DenseGridSpec``), the input of
:meth:`repro_torch.core.dse_engine.DSEEngine.reprice_grid`.

The reference package's budgeted search policies and surrogates
(``search/policy.py``, ``search/surrogate.py``) are not ported yet.
"""
from .grid import DenseGridSpec, ScaledWorkFn, scale_lattice, scaled_name

__all__ = ["DenseGridSpec", "ScaledWorkFn", "scale_lattice", "scaled_name"]
