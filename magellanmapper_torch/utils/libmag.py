"""General utilities (paths, sequences, dtypes, normalization).

Copy of ``magellanmapper_tpu/utils/libmag.py``: path manipulation
(``insert_before_ext``, ``splitext``, ``combine_paths``,
``make_out_path``), value normalization (``normalize``), integer-range
dtype selection (``dtype_within_range``), file backup before overwrite
(``backup_file``), enum, number and string helpers, and the version and
git commit of the checkout.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

#: multi-part extensions treated as a single suffix.
EXTS_COMPOUND = (".nii.gz", ".ome.tif", ".ome.tiff", ".tar.gz")


def splitext(path: str) -> Tuple[str, str]:
    """Split extension, keeping compound extensions intact."""
    lower = path.lower()
    for ext in EXTS_COMPOUND:
        if lower.endswith(ext):
            return path[: len(path) - len(ext)], path[len(path) - len(ext):]
    return os.path.splitext(path)


def insert_before_ext(path: str, insert: str, sep: str = "") -> str:
    """Insert ``insert`` before the file extension of ``path``."""
    base, ext = splitext(path)
    return f"{base}{sep}{insert}{ext}"


def combine_paths(
        base: Optional[str], suffix: str, sep: str = "_",
        ext: Optional[str] = None, check_dir: bool = False) -> str:
    """Combine a base path with a suffix, optionally replacing extension."""
    if not base:
        return suffix
    root, base_ext = splitext(base)
    if suffix.startswith("."):
        out = root + suffix
    else:
        out = f"{root}{sep}{suffix}"
    if ext:
        out = splitext(out)[0] + (ext if ext.startswith(".") else "." + ext)
    if check_dir:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    return out


def get_filename_without_ext(path: str) -> str:
    return splitext(os.path.basename(path))[0]


def backup_file(path: str, modifier: str = "") -> Optional[str]:
    """Move an existing file aside as ``path(.N)`` before overwrite.

    Returns the backup path or None if ``path`` does not exist (capability
    of reference ``libmag.backup_file:969``).
    """
    if not os.path.exists(path):
        return None
    i = 1
    while True:
        backup = insert_before_ext(path, f"{modifier}({i})")
        if not os.path.exists(backup):
            shutil.move(path, backup)
            return backup
        i += 1


def normalize(
        arr: np.ndarray, minimum: float, maximum: float,
        background: Optional[float] = None) -> np.ndarray:
    """Linearly rescale ``arr`` to ``[minimum, maximum]``.

    Values equal to ``background`` are excluded from the input range and
    mapped to ``minimum`` (reference ``libmag.normalize:449`` semantics).
    """
    arr = np.asarray(arr, dtype=float)
    if arr.size < 1:
        return arr
    if background is not None:
        fg = arr[arr != background]
        lo = fg.min() if fg.size else 0.0
        hi = fg.max() if fg.size else 1.0
    else:
        lo, hi = float(arr.min()), float(arr.max())
    denom = hi - lo
    if denom == 0:
        out = np.full_like(arr, minimum)
    else:
        out = (arr - lo) / denom * (maximum - minimum) + minimum
    if background is not None:
        out[arr == background] = minimum
    return out


_INT_TYPES = (np.uint8, np.int8, np.uint16, np.int16,
              np.uint32, np.int32, np.uint64, np.int64)


def dtype_within_range(
        min_val: float, max_val: float,
        integer: bool = True, signed: Optional[bool] = None) -> np.dtype:
    """Smallest dtype able to hold ``[min_val, max_val]``."""
    if not integer:
        for t in (np.float32, np.float64):
            info = np.finfo(t)
            if min_val >= info.min and max_val <= info.max:
                return np.dtype(t)
        raise ValueError("range too large for float64")
    for t in _INT_TYPES:
        if signed is True and np.issubdtype(t, np.unsignedinteger):
            continue
        if signed is False and np.issubdtype(t, np.signedinteger):
            continue
        info = np.iinfo(t)
        if min_val >= info.min and max_val <= info.max:
            return np.dtype(t)
    raise ValueError(f"range [{min_val}, {max_val}] too large for int64")


def to_seq(val: Any, n: Optional[int] = None) -> Optional[Sequence]:
    """Coerce scalars to sequences, broadcasting to length ``n``."""
    if val is None:
        return None
    if np.isscalar(val):
        return (val,) * (n or 1)
    seq = tuple(val)
    if n is not None and len(seq) == 1:
        seq = seq * n
    return seq


def pad_seq(seq: Sequence, length: int, pad: Any = None) -> list:
    """Pad or truncate a sequence to ``length``."""
    out = list(seq)[:length]
    out.extend([pad] * (length - len(out)))
    return out


def is_binary(img: np.ndarray) -> bool:
    """True if the image has at most two distinct values."""
    return np.unique(img).size <= 2


def format_bytes(num: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(num) < 1024:
            return f"{num:.1f}{unit}"
        num /= 1024
    return f"{num:.1f}PB"


def npstr_to_array(s: str) -> Optional[np.ndarray]:
    """Parse a stringified numpy array back into an array
    (reference ``libmag.npstr_to_array:882``)."""
    nums = re.findall(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?", s)
    if not nums:
        return None
    return np.array([float(n) for n in nums])


def make_abs_path(path: str, base_dir: Optional[str] = None) -> str:
    if os.path.isabs(path) or base_dir is None:
        return path
    return os.path.join(base_dir, path)


def is_seq(val: Any) -> bool:
    """True for list/tuple/ndarray (not strings)."""
    return isinstance(val, (list, tuple, np.ndarray))


def swap_elements(arr, axis0: int, axis1: int, offset: int = 0):
    """Swap two elements of a list/tuple/array; tuples come back as new
    tuples (reference ``libmag.swap_elements :46``)."""
    was_tuple = isinstance(arr, tuple)
    out = list(arr) if not isinstance(arr, np.ndarray) else arr.copy()
    i, j = axis0 + offset, axis1 + offset
    out[i], out[j] = out[j], out[i]
    return tuple(out) if was_tuple else out


def transpose_1d(arr, plane: str):
    """Reorder a z,y,x 1D sequence for an ``xz``/``yz`` plane view
    (reference ``libmag.transpose_1d :71``)."""
    if plane == "xz":
        return swap_elements(arr, 0, 1)
    if plane == "yz":
        return swap_elements(swap_elements(arr, 0, 2), 1, 2)
    return arr


def transpose_1d_rev(arr, plane: str):
    """Inverse of :func:`transpose_1d` (reference ``:83``)."""
    if plane == "xz":
        return swap_elements(arr, 1, 0)
    if plane == "yz":
        return swap_elements(swap_elements(arr, 2, 1), 2, 0)
    return arr


def roll_elements(arr, shift: int, axis: Optional[int] = None):
    """``np.roll`` that keeps tuples as tuples (reference ``:95``)."""
    was_tuple = isinstance(arr, tuple)
    out = np.roll(np.asarray(arr) if was_tuple else arr, shift, axis)
    return tuple(out) if was_tuple else out


def replace_seq(seq: Sequence, replacement: Sequence) -> np.ndarray:
    """Overlay ``replacement`` onto a copy of ``seq`` (as arrays),
    replacing as many leading values as fit (reference ``:165``)."""
    out = np.asarray(seq).copy()
    rep = np.asarray(replacement)
    n = min(len(out), len(rep))
    out[:n] = rep[:n]
    return out


def combine_arrs(arrs, filter_none: bool = True, fn=None, **kwargs):
    """Concatenate (or ``fn``) arrays after dropping ``None``s
    (reference ``:196``)."""
    if arrs is None:
        return None
    kept = [a for a in arrs if a is not None] if filter_none else list(arrs)
    kept = [a for a in kept if not (hasattr(a, "__len__") and len(a) == 0)]
    if not kept:
        return None
    return (fn or np.concatenate)(kept, **kwargs)


def flatten(vals):
    """Flatten arbitrarily nested sequences (generator, reference
    ``:230``)."""
    for val in vals:
        if is_seq(val):
            yield from flatten(val)
        else:
            yield val


def match_ext(path: str, path_to_match: str) -> str:
    """Give ``path_to_match`` the extension of ``path``
    (reference ``match_ext :296``)."""
    ext = splitext(path)[1]
    if not ext:
        return path_to_match
    return splitext(path_to_match)[0] + ext


def make_out_path(
        base_path: Optional[str] = None, prefix: Optional[str] = None,
        suffix: Optional[str] = None, combine_prefix: bool = False) -> str:
    """Output path from base/prefix/suffix: a prefix replaces the base
    unless ``combine_prefix`` (reference ``make_out_path :372``)."""
    path = base_path or ""
    if prefix and not combine_prefix:
        path = prefix
    elif prefix:
        path = os.path.join(os.path.dirname(path),
                            prefix + os.path.basename(path))
    if suffix:
        path = insert_before_ext(path, suffix)
    return path


def remove_file(path: str) -> bool:
    """Remove a file if present; True when removed (reference ``:404``)."""
    try:
        if os.path.isfile(path):
            os.remove(path)
            return True
    except OSError:
        pass
    return False


def last_lines(path: str, n: int) -> Optional[list]:
    """Last ``n`` lines of a text file (reference ``libmag.last_lines``)."""
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return f.readlines()[-n:]


def get_int(val):
    """Parse to int, then float, else return unchanged (reference
    ``libmag.get_int``)."""
    try:
        return int(val)
    except (TypeError, ValueError):
        try:
            return float(val)
        except (TypeError, ValueError):
            return val


def is_int(val) -> bool:
    """True if value is integral (reference ``libmag.is_int``)."""
    try:
        return float(val).is_integer()
    except (TypeError, ValueError):
        return False


def is_number(val) -> bool:
    """True if value parses as a number (reference ``libmag.is_number``)."""
    try:
        float(val)
        return True
    except (TypeError, ValueError):
        return False


#: verbosity flag for :func:`printv` (reference ``config.verbose``)
verbose = False
_LOGGED_ONCE = set()


def printv(*args, **kwargs) -> None:
    """Print only in verbose mode (reference ``libmag.printv``)."""
    if verbose:
        print(*args, **kwargs)


def printcb(msg, fn_callback=None) -> None:
    """Print and also forward to a callback
    (reference ``libmag.printcb``)."""
    print(msg)
    if fn_callback is not None:
        fn_callback(msg)


def warn(msg: str, category=UserWarning) -> None:
    """Show a warning (reference ``libmag.warn``)."""
    import warnings
    warnings.warn(msg, category)


def log_once(fn_log, msg: str) -> None:
    """Log a message only the first time it appears
    (reference ``libmag.log_once :525``)."""
    if msg not in _LOGGED_ONCE:
        _LOGGED_ONCE.add(msg)
        fn_log(msg)


def series_as_str(series) -> str:
    """Series number zero-padded to 5 chars
    (reference ``libmag.series_as_str :538``)."""
    return str(series).zfill(5)


def splice_before(base: str, search: str, splice: str,
                  post_splice: str = "") -> str:
    """Insert ``splice`` before ``search`` in ``base``; append if not
    found (reference ``libmag.splice_before :551``)."""
    i = base.find(search)
    if i == -1:
        return base + splice + post_splice
    return base[:i] + splice + post_splice + base[i:]


def str_to_disp(s: str) -> str:
    """Underscores to spaces, trimmed (reference ``str_to_disp :573``)."""
    return s.replace("_", " ").strip()


def crop_mid_str(vals: Sequence[str], max_chars: int = 10,
                 unique: bool = True) -> list:
    """Replace string middles with ``...``, keeping outputs unique
    (reference ``libmag.crop_mid_str :586``)."""
    out = []
    half = max_chars // 2
    for val in vals:
        if len(val) <= max_chars:
            cropped = val
        else:
            cropped = val[:half] + "..." + val[len(val) - (
                max_chars - half):]
        while unique and cropped in out:
            cropped = cropped.replace("...", "....", 1)
        out.append(cropped)
    return out


def make_acronym(val: Optional[str], delim: str = " ",
                 ignore: Optional[Sequence[str]] = None,
                 caps: bool = False, num_single: int = 3) -> Optional[str]:
    """First letters of words, skipping ``of``/``the``
    (reference ``libmag.make_acronym :628``)."""
    if not val:
        return val
    if ignore is None:
        ignore = ("of", "the")
    words = [w for w in val.split(delim)
             if w.lower() not in [i.lower() for i in ignore]]
    if len(words) <= 1:
        out = val[:num_single]
    else:
        out = "".join(w[0] for w in words if w)
    return out.upper() if caps else out


def is_nan(val) -> Union[bool, np.ndarray]:
    """NaN test that tolerates non-numeric types
    (reference ``libmag.is_nan``)."""
    try:
        return np.isnan(val)
    except TypeError:
        return False


def format_num(val, dec_digits: int = 1, allow_scinot: bool = True):
    """Format numbers to limited decimals; pass through non-numbers
    (reference ``libmag.format_num :751``)."""
    if not is_number(val):
        return val
    num = float(val)
    if float(num).is_integer():
        return str(int(num))
    fmt = "g" if allow_scinot else "f"
    return f"{num:.{dec_digits}{fmt}}"


def truncate_decimal_digit(val, repeats: int = 3,
                           trim_near: bool = False):
    """Trim float-representation artifacts like 3.0000000000000004
    (reference ``libmag.truncate_decimal_digit :800``)."""
    s = repr(float(val))
    if "." not in s or "e" in s or "E" in s:
        return float(val)
    whole, frac = s.split(".")
    run_char = None
    run_len = 0
    for i, ch in enumerate(frac):
        if ch == run_char:
            run_len += 1
            if run_len >= repeats and not (
                    run_char == "0" and abs(float(val)) < 1
                    and frac[:i - run_len + 1].strip("0") == ""):
                return float(whole + "." + frac[:i - run_len + 1])
        else:
            run_char = ch
            run_len = 1
    return float(val)


def convert_bin_magnitude(val, orders: int):
    """Shift by binary orders of magnitude (1024^orders)
    (reference ``libmag.convert_bin_magnitude :850``)."""
    return val / 1024 ** orders


def convert_indices_to_int(dict_to_convert: dict) -> dict:
    """Convert dict values to ints where possible
    (reference ``libmag.convert_indices_to_int``)."""
    return {k: ([int(i) for i in v] if isinstance(v, (list, tuple))
                else int(v)) if v is not None else v
            for k, v in dict_to_convert.items()}


def show_full_arrays(on: bool = True) -> None:
    """Toggle full numpy array printing
    (reference ``libmag.show_full_arrays``)."""
    if on:
        np.set_printoptions(linewidth=500, threshold=10000000)
    else:
        np.set_printoptions()


def print_compact(arr, label: Optional[str] = None,
                  allow_scinot: bool = False) -> None:
    """Print an array with compact float formatting
    (reference ``libmag.print_compact``)."""
    with np.printoptions(precision=3, suppress=not allow_scinot):
        if label:
            print(label)
        print(arr)


def compact_float(val, dec_digits: int = 1):
    """Int if integral, else rounded float
    (reference ``libmag.compact_float``)."""
    if is_int(val):
        return int(float(val))
    if is_number(val):
        return round(float(val), dec_digits)
    return val


def copy_backup(path: str, suffix: str = "bkup") -> Optional[str]:
    """Copy a file alongside itself as a backup
    (reference ``libmag.copy_backup``)."""
    if not os.path.exists(path):
        return None
    out = insert_before_ext(path, suffix, "_")
    shutil.copy2(path, out)
    return out


def create_symlink(src: str, dst: str) -> bool:
    """Symlink with fallback to copy on platforms without link perms
    (reference ``libmag.create_symlink``)."""
    try:
        os.symlink(src, dst)
        return True
    except (OSError, NotImplementedError):
        shutil.copy2(src, dst)
        return False


def coords_for_indexing(coords: np.ndarray) -> np.ndarray:
    """(n, m) coordinates to split axis arrays for fancy indexing
    (reference ``libmag.coords_for_indexing :1098``)."""
    coordsi = np.transpose(coords)
    return np.split(coordsi, coordsi.shape[0])


def get_dtype_info(arr_or_dtype):
    """iinfo/finfo for an array or dtype
    (reference ``libmag.get_dtype_info``)."""
    dtype = getattr(arr_or_dtype, "dtype", arr_or_dtype)
    dtype = np.dtype(dtype)
    return np.iinfo(dtype) if np.issubdtype(dtype, np.integer) \
        else np.finfo(dtype)


def get_if_within(val, i: int, default=None):
    """``val[i]`` when in range, scalar passthrough otherwise
    (reference ``libmag.get_if_within``)."""
    if not is_seq(val):
        return val
    return val[i] if i < len(val) else default


def enum_names_aslist(enum_cls) -> list:
    """Member names of an enum (reference ``enum_names_aslist``)."""
    return [e.name for e in enum_cls]


def enum_dict_aslist(enum_dict: dict) -> list:
    """Enum-keyed dict as (name, value) tuples
    (reference ``enum_dict_aslist``)."""
    return [(k.name if hasattr(k, "name") else k, v)
            for k, v in enum_dict.items()]


def get_enum(val: str, enum_cls):
    """Look up an enum by name, case-insensitive; None if absent
    (reference ``libmag.get_enum``)."""
    if isinstance(val, enum_cls):
        return val
    for member in enum_cls:
        if member.name.lower() == str(val).lower():
            return member
    return None


def get_dict_keys_from_val(d: dict, val) -> list:
    """All keys mapping to a value (reference
    ``get_dict_keys_from_val``)."""
    return [k for k, v in d.items() if v == val]


def add_missing_keys(src: dict, dest: dict) -> dict:
    """Copy entries absent from ``dest`` (reference
    ``libmag.add_missing_keys``)."""
    for k, v in src.items():
        dest.setdefault(k, v)
    return dest


def scale_slice(sl: slice, scale: float,
                size: Optional[int] = None) -> slice:
    """Scale a slice's bounds (reference ``libmag.scale_slice``)."""
    start = None if sl.start is None else int(sl.start * scale)
    stop = int(sl.stop * scale) if sl.stop is not None else (
        int(size) if size is not None else None)
    step = None if sl.step is None else max(int(sl.step * scale), 1)
    return slice(start, stop, step)


def get_git_commit(repo_dir: str = ".") -> Optional[str]:
    """Current git commit hash, or None outside a repo
    (reference ``libmag.get_git_commit``)."""
    import subprocess
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            stderr=subprocess.DEVNULL).decode().strip()
    except (subprocess.CalledProcessError, OSError):
        return None


def get_version(packaged: bool = False) -> str:
    """Framework version string (reference ``libmag.get_version``)."""
    try:
        import magellanmapper_torch
        return getattr(magellanmapper_torch, "__version__", "0.1.0")
    except ImportError:
        return "0.1.0"
