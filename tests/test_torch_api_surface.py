"""The port's library surface is the reference's: every public name of
every reference module has a counterpart under the same module path and
name in ``magellanmapper_torch``, and every public function and method
takes the reference's parameters in the reference's order.

The reference's modules are read with ``ast``, never imported, so this
file loads no JAX. A module's public names are its top-level functions
and classes, the public methods of those classes, its module-level
assignments and the names it binds with ``from magellanmapper_tpu.<m>
import <name>`` where ``<name>`` is not a module; third-party imports,
imported submodules and names the module deletes with ``del`` are not
part of it. The port may add names, and parameters (such as ``device``),
anywhere.
"""

import ast
import importlib
import inspect
import pathlib

import pytest

REF_ROOT = pathlib.Path(__file__).resolve().parents[1] / "magellanmapper_tpu"
PORT_ROOT = REF_ROOT.parent / "magellanmapper_torch"

#: what the port has no counterpart for, each with its reason: a module
#: by its path, a name as ``path:name``
NOT_PORTED = {
    "ops/pallas_kernels.py": "the four Pallas TPU kernels, ported as "
                             "CUDA C++ under kernels/ and csrc/",
    "cv/ref_detect.py": "a CPU oracle of the reference's own tests",
    "native/__init__.py": "the reference's native block reader, covered "
                          "by io/_blockio.py and csrc/host/",
    "ops/peaks.py:fused_peaks_fit": "the TPU's VMEM budget of the fused "
                                    "peak route (ROADMAP, not to port)",
}

#: parameters of a reference function that the port does not take, with
#: the reason, by ``(path, name)``
PARAMS_NOT_PORTED = {
    ("cv/stack_detect.py", "detect_blobs_blocks"): (
        ("near_max", "verify_fn"),
        "the port always measures near-max from the image, and verifies "
        "blobs outside the detector (cli.detect)"),
}

REF_MODULES = sorted(
    str(p.relative_to(REF_ROOT)) for p in REF_ROOT.rglob("*.py"))


def _port_module(path: str):
    parts = pathlib.PurePosixPath(path).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(("magellanmapper_torch",) + parts))


def _is_ref_module(module: str, name: str) -> bool:
    base = REF_ROOT.joinpath(*module.split(".")[1:], name)
    return base.with_suffix(".py").exists() or (base / "__init__.py").exists()


def _tree(path: str) -> ast.Module:
    return ast.parse((REF_ROOT / path).read_text())


def _public(name: str) -> bool:
    return not name.startswith("_")


def ref_names(path: str):
    """The public names of a reference module, in source order."""
    body = _tree(path).body
    deleted = {t.id for node in body if isinstance(node, ast.Delete)
               for t in node.targets if isinstance(t, ast.Name)}
    names = []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                          and _public(sub.name)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names += [n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name) and _public(n.id)]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and (node.module or "").split(".")[0] == "magellanmapper_tpu"):
            names += [a.asname or a.name for a in node.names
                      if _public(a.asname or a.name)
                      and not _is_ref_module(node.module, a.name)]
    return [n for n in dict.fromkeys(names)
            if n.split(".")[0] not in deleted]


def _has(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("path", REF_MODULES)
def test_reference_names_exist_in_the_port(path):
    if path in NOT_PORTED:
        assert not (PORT_ROOT / path).exists(), (
            f"{path} is ported now: take it off NOT_PORTED")
        return
    port = _port_module(path)
    allowed = {key.split(":", 1)[1] for key in NOT_PORTED
               if key.startswith(path + ":")}
    names = ref_names(path)
    missing = [n for n in names if n not in allowed and not _has(port, n)]
    assert not missing, f"{path}: the port lacks {missing}"
    stale = sorted(n for n in allowed if n not in names or _has(port, n))
    assert not stale, f"{path}: stale NOT_PORTED entries {stale}"


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entries_name_reference_code(key):
    path, _, name = key.partition(":")
    assert (REF_ROOT / path).exists(), f"{key}: no such reference module"
    assert not name or name in ref_names(path), (
        f"{key}: the reference has no such name")
    assert NOT_PORTED[key]


def _arg_names(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    names += [x.arg for x in a.kwonlyargs]
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return names


def _accessor(fn: ast.FunctionDef):
    """``fset``/``fdel`` for a property's setter or deleter, else None."""
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Attribute) and dec.attr in ("setter",
                                                           "deleter"):
            return "f" + dec.attr[:3]
    return None


def ref_functions(path: str):
    """``(name, parameters, accessor)`` of each public function, and of
    each public method and ``__init__`` of a public class."""
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _public(node.name):
            yield node.name, _arg_names(node), None
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (_public(sub.name) or sub.name == "__init__"):
                    yield (f"{node.name}.{sub.name}", _arg_names(sub),
                           _accessor(sub))


def _port_callable(module, dotted: str, accessor):
    *owners, last = dotted.split(".")
    obj = module
    for part in owners:
        obj = getattr(obj, part)
    if not owners:
        obj = getattr(obj, last)
        return obj.__init__ if inspect.isclass(obj) else obj
    # unwrap static and class methods and properties as defined
    obj = inspect.getattr_static(obj, last)
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        obj = getattr(obj, accessor or "fget")
    return obj


def _port_params(fn):
    out = []
    for p in inspect.signature(fn).parameters.values():
        prefix = {p.VAR_POSITIONAL: "*", p.VAR_KEYWORD: "**"}.get(p.kind, "")
        out.append(prefix + p.name)
    return out


def _in_order(want, got) -> bool:
    it = iter(got)
    return all(name in it for name in want)


@pytest.mark.parametrize(
    "path", [p for p in REF_MODULES if p not in NOT_PORTED])
def test_reference_parameters_are_in_the_port(path):
    port = _port_module(path)
    wrong = []
    for name, params, accessor in ref_functions(path):
        if not _has(port, name):
            continue  # the names test reports it
        got = _port_params(_port_callable(port, name, accessor))
        dropped, _ = PARAMS_NOT_PORTED.get((path, name), ((), None))
        if dropped:
            assert not set(dropped) & set(got), (
                f"{path}:{name} takes {dropped} now: take it off "
                "PARAMS_NOT_PORTED")
        want = [p for p in params if p not in dropped]
        if not _in_order(want, got):
            wrong.append(f"{name}: reference {params}, port {got}")
    assert not wrong, f"{path}: " + "; ".join(wrong)


@pytest.mark.parametrize("key", sorted(PARAMS_NOT_PORTED))
def test_params_not_ported_name_reference_parameters(key):
    path, name = key
    dropped, reason = PARAMS_NOT_PORTED[key]
    params = {n: p for n, p, _ in ref_functions(path)}
    assert name in params, f"{key}: the reference has no such function"
    assert set(dropped) <= set(params[name]) and reason
