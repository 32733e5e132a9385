"""Estimator parameter dumps.

Reference parity: Spark's ``explainParams`` printed before expensive fits
(``Word2VecCorpusBuilder.scala:85``) so the exact hyperparameters of a run are
in its log. Estimators here are dataclasses, so the dump is their fields.

Host code, copied from ``albedo_tpu/utils/params.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any


# Infrastructure fields elided from dumps: runtime wiring, not
# hyperparameters. Meaningful None HYPERparameters (e.g. ImplicitALS
# max_len=None, gather_dtype=None) print like Spark's explainParams prints
# defaults — two configs differing only in a None-vs-set field must not dump
# identically. The port's ``device`` is runtime wiring too, so a dump reads
# the same on the card and on the CPU.
_INFRA_FIELDS = frozenset({"mesh", "init_factors", "callback", "device"})


def explain_params(estimator: Any) -> str:
    """``name: field=value, ...`` over dataclass fields (non-dataclasses fall
    back to their public ``__dict__``), eliding only the explicit
    infrastructure fields (``_INFRA_FIELDS``)."""
    name = type(estimator).__name__
    if dataclasses.is_dataclass(estimator):
        pairs = [
            (f.name, getattr(estimator, f.name))
            for f in dataclasses.fields(estimator)
        ]
    else:
        pairs = [
            (k, v) for k, v in vars(estimator).items() if not k.startswith("_")
        ]
    body = ", ".join(f"{k}={v!r}" for k, v in pairs if k not in _INFRA_FIELDS)
    return f"{name}({body})"
