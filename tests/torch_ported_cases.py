"""Run a reference test file's cases on both packages.

`ported(ns, "test_remote_store")` reads `tests/test_remote_store.py`, runs
its source once as written (the JAX package) and once with the package's
name changed to `openwhisk_tpu_torch` (the port), and puts into `ns` (a
test module's globals) one case per reference case, each taking the `pkg`
fixture, whose value (`"openwhisk_tpu"` or `"openwhisk_tpu_torch"`) picks
which run's function executes. The case's code is the reference's, line for
line; only the package name and the substitutions a file asks for change.

  - Module-level test functions and `Test*` classes become cases of the
    same names; their marks (`slow`, `kafka`, `skipif`, `parametrize`) are
    the reference's.
  - The file's fixtures become fixtures of the same names that run the
    chosen package's fixture body (a fixture's `params` stay).
  - A class case makes one instance of the chosen package's class per
    test, shared by its fixture methods and its test method.
  - `from tests.test_x import ...` inside the port's run names the port's
    run of `tests/test_x.py` (its module code only, no cases collected).
  - `ports=(...)` replaces each fixed port number in the source by a free
    one, per run (a number one past another listed one stays one past
    it): the reference files bind those numbers at the same time under
    `-n`.
  - `subs={root: [(old, new), ...]}` replaces source text in that
    package's run only: the named differences of the port (its controller
    places on the card unless told `device="cpu"`).
"""
import inspect
import re
import socket
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("openwhisk_tpu", "openwhisk_tpu_torch")
_RUNS = {}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fixture(fn=None, **kw):
    """The reference's `@pytest.fixture` inside a run: the raw function,
    its keyword arguments kept for the case's fixture."""
    if fn is None:
        return lambda f: _fixture(f, **kw)
    fn._ported_fixture = kw
    return fn


def _source(ref, root, ports, subs):
    src = (TESTS / f"{ref}.py").read_text()
    if root != PACKAGES[0]:
        src = re.sub(r"\bopenwhisk_tpu\b", root, src)
        src = re.sub(r"\btests\.(test_\w+)", rf"_ported_{root}.\1", src)
    for old, new in subs.get(root, ()):
        assert old in src, (ref, old)
        src = src.replace(old, new)
    mapped = {}
    for lit in ports:
        prev = str(int(lit) - 1)
        mapped[lit] = mapped[prev] + 1 if prev in mapped else _free_port()
        src = re.sub(rf"\b{lit}\b", str(mapped[lit]), src)
    return re.sub(r"@pytest\.fixture\b", "@_ported_fixture", src)


def load(ref, root, ports=(), subs=None):
    """One package's run of `tests/<ref>.py`, as a module."""
    key = (ref, root)
    if key not in _RUNS:
        name = f"_ported_{root}.{ref}"
        mod = types.ModuleType(name)
        mod.__file__ = str(TESTS / f"{ref}.py")
        mod._ported_fixture = _fixture
        sys.modules.setdefault(f"_ported_{root}", types.ModuleType(
            f"_ported_{root}"))
        sys.modules[name] = mod
        if root != PACKAGES[0]:
            # the helper modules it names, in the same package
            for dep in re.findall(r"\btests\.(test_\w+)",
                                  (TESTS / f"{ref}.py").read_text()):
                if dep != ref:
                    load(dep, root)
        code = compile(_source(ref, root, ports, subs or {}), mod.__file__,
                       "exec")
        exec(code, mod.__dict__)
        _RUNS[key] = mod
    return _RUNS[key]


def _signature(fn, first=()):
    params = list(inspect.signature(fn).parameters.values())
    lead = params[:len(first)]
    return inspect.Signature(lead + [inspect.Parameter(
        "pkg", inspect.Parameter.POSITIONAL_OR_KEYWORD)] + params[len(first):])


def _case(fns):
    fn = fns[PACKAGES[1]]

    def case(pkg, **kw):
        return fns[pkg](**kw)

    case.__signature__ = _signature(fn)
    case.__name__ = case.__qualname__ = fn.__name__
    case.__doc__ = fn.__doc__
    case.pytestmark = list(getattr(fn, "pytestmark", []))
    return case


def _fixture_of(fns, name, method=False):
    fn = fns[PACKAGES[1]]
    kw = dict(fn._ported_fixture)

    def fixture(*args, pkg, **kw2):
        f = fns[pkg]
        if method:  # args: the case's instance
            args = (_instance(args[0], pkg),)
        if inspect.isgeneratorfunction(f):
            yield from f(*args, **kw2)
        else:
            yield f(*args, **kw2)

    fixture.__signature__ = _signature(fn, first=("self",) if method else ())
    fixture.__name__ = name
    return pytest.fixture(**kw)(fixture)


def _instance(case_self, pkg):
    """The chosen package's instance of the reference class, one per test
    (pytest makes one case instance per test)."""
    made = case_self.__dict__.setdefault("_ported", {})
    if pkg not in made:
        made[pkg] = case_self._ported_classes[pkg]()
    return made[pkg]


def _method_case(classes, name):
    fn = getattr(classes[PACKAGES[1]], name)

    def case(self, pkg, **kw):
        return getattr(_instance(self, pkg), name)(**kw)

    case.__signature__ = _signature(fn, first=("self",))
    case.__name__ = case.__qualname__ = name
    case.__doc__ = fn.__doc__
    case.pytestmark = list(getattr(fn, "pytestmark", []))
    return case


def _class_case(classes, name):
    cls = classes[PACKAGES[1]]
    body = {"_ported_classes": classes, "__doc__": cls.__doc__}
    for attr, value in vars(cls).items():
        if attr.startswith("test") and callable(value):
            body[attr] = _method_case(classes, attr)
        elif hasattr(value, "_ported_fixture"):
            body[attr] = _fixture_of(
                {r: vars(c)[attr] for r, c in classes.items()}, attr,
                method=True)
    case = type(name, (), body)
    case.pytestmark = list(getattr(cls, "pytestmark", []))
    return case


def ported(ns, ref, only=None, ports=(), subs=None):
    """Put `tests/<ref>.py`'s cases (or those named in `only`) into `ns`
    as cases on both packages."""
    runs = {root: load(ref, root, ports, subs) for root in PACKAGES}
    port = runs[PACKAGES[1]]
    assert not hasattr(port, "pytestmark"), "module marks are not carried"
    leaked = [n for n, v in vars(port).items()
              if getattr(v, "__module__", None) is not None
              and str(v.__module__).split(".")[0] == PACKAGES[0]]
    assert not leaked, f"the port's run of {ref} names the JAX package: " \
                       f"{leaked}"
    for name, value in vars(port).items():
        if only is not None and name not in only:
            continue
        objs = {r: vars(m)[name] for r, m in runs.items()}
        if hasattr(value, "_ported_fixture"):
            assert name not in ns, name
            ns[name] = _fixture_of(objs, name)
        elif inspect.isclass(value) and name.startswith("Test"):
            assert name not in ns, name
            ns[name] = _class_case(objs, name)
        elif inspect.isfunction(value) and name.startswith("test"):
            assert name not in ns, name
            ns[name] = _case(objs)
    ns.setdefault("pkg", _pkg)


@pytest.fixture(params=PACKAGES, name="pkg")
def _pkg(request):
    return request.param
