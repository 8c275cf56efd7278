"""Faults planted in the program under test, for the checks that
``correct`` comes out false when the timed path is broken underneath.

Each breaks one function of the program where its answer is produced:
for detection, half of a pass's blocks left out (every other block's
rows dropped) or one row of each block moved by a voxel; for the sweep,
half of each threshold's rows left out, or the verification's
sensitivity scaled by 0.9. A step that returns its state unchanged and a
missing exchange between chips have no counterpart: neither cell keeps
state across calls, and each runs on one card.
"""

import contextlib
import importlib

_SD = "magellanmapper_torch.cv.stack_detect"
_DET = "magellanmapper_torch.cv.detector"
_VER = "magellanmapper_torch.cv.verifier"


def half_the_blocks(step):
    seen = [0]

    def broken(block, params, capacity=None):
        raw, valid, count = step(block, params, capacity)
        seen[0] += 1
        return raw, valid & (seen[0] % 2 == 0), count
    return broken


def one_row_moved(step):
    def broken(block, params, capacity=None):
        raw, valid, count = step(block, params, capacity)
        raw = raw.clone()
        raw[0, 0] += 1.0
        return raw, valid, count
    return broken


def half_the_rows(multi):
    def broken(*args, **kwargs):
        rows, valid = multi(*args, **kwargs)
        valid = valid.clone()
        valid[:, ::2] = False
        return rows, valid
    return broken


def scores_altered(verify):
    def broken(blobs, truth, tol):
        sens, ppv, msg = verify(blobs, truth, tol)
        return sens * 0.9, ppv, msg
    return broken


#: by driver, each fault's name -> (module, function, breaker)
FAULTS = {
    "detect": {
        "half_the_blocks": (_SD, "detect_step", half_the_blocks),
        "one_row_moved": (_SD, "detect_step", one_row_moved),
    },
    "sweep": {
        "half_the_rows": (_DET, "blob_log_multi", half_the_rows),
        "scores_altered": (_VER, "verify_stack", scores_altered),
    },
}


@contextlib.contextmanager
def planted(driver: str, name: str):
    """The program with fault ``name`` of ``driver``'s cells planted,
    restored on exit."""
    mod_name, attr, breaker = FAULTS[driver][name]
    mod = importlib.import_module(mod_name)
    original = getattr(mod, attr)
    setattr(mod, attr, breaker(original))
    try:
        yield
    finally:
        setattr(mod, attr, original)
