"""Port parity, public surface: every public function and class method of
``repro`` has a twin of the same name in ``repro_torch`` that takes the
reference's parameters in the reference's order and kinds.  The port may
add optional parameters (``device=``, ``sums=``).  The deviations are the
deliberate ones: the TPU-only knobs and names, and ``GraphDelta`` and
``FrontierResult``, which hold their arrays on the device."""

import importlib
import inspect
import pkgutil

import repro
import repro_torch

# Parameters the port does not take: the TPU's knobs.
TPU_PARAMS = {"interpret", "tile", "schedule", "xla_flags", "xla_flag_sets"}
# Names the port does not have: the TPU's.
TPU_NAMES = {"support_fine_pallas", "support_dense_pallas", "on_tpu", "DEFAULT_XLA_FLAG_SETS"}
# Built from tensors held on the device (their numpy fields are read back lazily).
DEVICE_HELD = {"GraphDelta.__init__", "FrontierResult.__init__"}


def _modules(pkg):
    return {
        m.name.split(".", 1)[1]: m.name
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
        if ".examples" not in m.name and not m.name.endswith("__main__")
    }


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return None


def _differs(ref, port) -> bool:
    """``ref``'s parameters (TPU knobs aside) are not ``port``'s shared ones
    in the same order and kinds, or the port requires one more."""
    a, b = _params(ref), _params(port)
    if a is None or b is None:
        return a != b
    a = [p for p in a if p.name not in TPU_PARAMS]
    names = {p.name for p in a}
    extra_required = [p for p in b if p.name not in names and p.default is p.empty
                      and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    shared = [(p.name, p.kind) for p in b if p.name in names]
    return bool(extra_required) or [(p.name, p.kind) for p in a] != shared


def _surface_differences() -> list[str]:
    ref, port = _modules(repro), _modules(repro_torch)
    out = []
    for name in sorted(set(ref) & set(port)):
        rm, tm = importlib.import_module(ref[name]), importlib.import_module(port[name])
        for attr in getattr(rm, "__all__", []):
            if attr in TPU_NAMES:
                continue
            if not hasattr(tm, attr):
                out.append(f"{name}.{attr} missing")
                continue
            a, b = getattr(rm, attr), getattr(tm, attr)
            if inspect.isfunction(a) and _differs(a, b):
                out.append(f"{name}.{attr}")
            elif inspect.isclass(a):
                for meth, fa in inspect.getmembers(a, inspect.isfunction):
                    if (meth.startswith("_") and meth != "__init__") or (
                        f"{attr}.{meth}" in DEVICE_HELD
                    ):
                        continue
                    fb = getattr(b, meth, None)
                    if fb is None or _differs(fa, fb):
                        out.append(f"{name}.{attr}.{meth}")
    return out


def test_public_surface_matches_reference_but_the_deliberate_deviations():
    assert _surface_differences() == []
