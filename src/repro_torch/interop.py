"""State carried across from the reference package.

The system has no weights: what crosses over is the problem and the
solved policy.  Both converters read the reference objects by duck
typing -- attribute names and ``dataclasses.fields`` -- and never import
the reference package, so this module works with or without it.

  * ``spec_from_reference(spec)`` rebuilds a reference ``SMDPSpec`` (with
    its ``ServiceModel`` and latency / energy profile dataclasses) as the
    port's ``SMDPSpec``;
  * ``table_from_reference(result)`` turns a reference ``SolveResult``'s
    policy into the port's ``SMDPScheduler``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core import profiles, service_models
from .core.smdp import SMDPSpec
from .serving.scheduler import SMDPScheduler

#: port classes a reference dataclass maps to, by class name
_CLASSES = {
    cls.__name__: cls
    for cls in (
        service_models.AffineProfile,
        service_models.ConstantProfile,
        service_models.LogProfile,
        service_models.TableProfile,
        service_models.PiecewiseMaxProfile,
        service_models.ServiceModel,
        profiles.TPUEnergyProfile,
        SMDPSpec,
    )
}


def _convert(obj):
    """Rebuild a reference dataclass (recursively) as its port class."""
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    cls = _CLASSES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(
            f"no port counterpart for {type(obj).__module__}."
            f"{type(obj).__name__}"
        )
    kwargs = {
        f.name: _convert(getattr(obj, f.name)) for f in dataclasses.fields(obj)
    }
    return cls(**kwargs)


def spec_from_reference(spec) -> SMDPSpec:
    """The port's SMDPSpec for a reference SMDPSpec (same problem)."""
    out = _convert(spec)
    if not isinstance(out, SMDPSpec):
        raise TypeError(f"expected an SMDPSpec, got {type(spec).__name__}")
    return out


def table_from_reference(result) -> SMDPScheduler:
    """The port's SMDPScheduler on a reference SolveResult's action table."""
    return SMDPScheduler.from_table(
        np.asarray(result.action_table(), dtype=np.int64)
    )
