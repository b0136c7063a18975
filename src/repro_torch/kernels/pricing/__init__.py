"""The DSE pricing kernel: the backend matrix.

Two instantiations of one CUDA kernel (``csrc/pricing.cu``) sit behind
``repro_torch.core.pricing.price_plans``:

================  ======  =============================================
backend name      dtype   guarantee
================  ======  =============================================
``kernel``        f64     bit-identical to the numpy scalar reference
                          (``certify``)
``kernel-f32``    f32     every output within the declared relative
                          drift band δ of the f64 reference
                          (``certify_f32``)
================  ======  =============================================

On a CPU device both run the kernel's plain PyTorch version
(:func:`.ref.pricing_ref`). Selection: ``DSEEngine(pricing_backend=...)``
/ ``price_plans(backend=...)`` take the backend *name*; ``"auto"`` is
``kernel``. ``kernel-f32`` is the only backend in
``repro_torch.core.pricing.APPROX_BACKENDS``: decisions made from its f32
columns go through the drift-budget contract in :mod:`.drift` (banded
candidate selection via :func:`banded_winner_rows` — every row within δ of
the f32 argmin is re-priced exactly in f64 — then
:func:`certify_banded_rows`, which raises :class:`DriftBandError` if
observed drift ever exceeds δ). Final winner pricing resolves to
``repro_torch.core.pricing.exact_backend``, so sweep outputs stay
bit-identical to the scalar reference end to end. The band δ is an
argument (default ``1e-5``)."""
from .drift import (DRIFT_BAND, BandedSelection, DriftBandError,
                    banded_winner_rows, certify_banded_rows, drift_band)
from .ops import (certify, certify_f32, kernel_columns, pricing_f32,
                  pricing_f64)

__all__ = ["certify", "certify_f32", "kernel_columns", "pricing_f32",
           "pricing_f64", "banded_winner_rows", "certify_banded_rows",
           "drift_band", "BandedSelection", "DriftBandError", "DRIFT_BAND"]
