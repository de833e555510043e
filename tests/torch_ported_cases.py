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
    `-n`. Ports are drawn free to bind, from DRAW_RANGE, below the
    kernel's ephemeral range: there no outgoing connection can take one
    between the draw and the standalone's bind. A case whose bind of one
    of its drawn ports still finds it taken (an EADDRINUSE error that names
    the port) runs again on a fresh draw of its file, PORT_ATTEMPTS times
    at most. Only the case's body runs again: its fixtures ran before it
    and are not redrawn, so a bind inside a fixture gets no second run.
  - `subs={root: [(old, new), ...]}` replaces source text in that
    package's run only: the named differences of the port (its controller
    places on the card unless told `device="cpu"`).
"""
import errno
import inspect
import random
import re
import socket
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
PACKAGES = ("openwhisk_tpu", "openwhisk_tpu_torch")
_RUNS = {}
#: where ports are drawn: above the fixed ports the reference tests bind
#: (13,000-15,000) and below the kernel's ephemeral range (32,768 and up by
#: default), from which connections and port-0 binds take theirs
DRAW_RANGE = (20000, 30000)
#: a case's runs in all when its standalone finds its port taken
PORT_ATTEMPTS = 3
_draws = random.Random()


def _ephemeral_low() -> int:
    try:
        return int(Path("/proc/sys/net/ipv4/ip_local_port_range")
                   .read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def _free_block(width: int) -> int:
    """The first of `width` consecutive ports, each free to bind now,
    drawn from DRAW_RANGE below the ephemeral range."""
    lo = DRAW_RANGE[0]
    hi = min(DRAW_RANGE[1], _ephemeral_low()) - width
    for _ in range(1000):
        base = _draws.randrange(lo, hi)
        if all(_bindable(base + i) for i in range(width)):
            return base
    raise RuntimeError(f"no {width} free ports in {lo}-{hi + width}")


def _free_port():
    return _free_block(1)


def _port_taken(exc: BaseException, ports) -> bool:
    """Did a bind of one of `ports` in `exc` (or in what caused it) find
    its port taken? Only an EADDRINUSE error that names the port counts
    (asyncio's bind error names its address): one that names another port,
    or none, is a failure of the code under test."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        text = str(exc).lower()
        in_use = ((isinstance(exc, OSError) and exc.errno == errno.EADDRINUSE)
                  or f"[errno {errno.EADDRINUSE}]" in text)
        if in_use and any(re.search(rf"\b{p}\b", text) for p in ports):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def _fixture(fn=None, **kw):
    """The reference's `@pytest.fixture` inside a run: the raw function,
    its keyword arguments kept for the case's fixture."""
    if fn is None:
        return lambda f: _fixture(f, **kw)
    fn._ported_fixture = kw
    return fn


def _source(ref, root, ports, subs):
    """The run's source and the ports drawn for it."""
    src = (TESTS / f"{ref}.py").read_text()
    if root != PACKAGES[0]:
        src = re.sub(r"\bopenwhisk_tpu\b", root, src)
        src = re.sub(r"\btests\.(test_\w+)", rf"_ported_{root}.\1", src)
    for old, new in subs.get(root, ()):
        assert old in src, (ref, old)
        src = src.replace(old, new)
    # each run of consecutive literals (and one port past it, which a
    # source may take as PORT + 1) is one block drawn free
    mapped = {}
    for lit in sorted(ports, key=int):
        if str(int(lit) - 1) in mapped:
            continue
        width = 1
        while str(int(lit) + width) in ports:
            width += 1
        base = _free_block(width + 1)
        for i in range(width):
            mapped[str(int(lit) + i)] = base + i
    for lit in ports:
        src = re.sub(rf"\b{lit}\b", str(mapped[lit]), src)
    src = re.sub(r"@pytest\.fixture\b", "@_ported_fixture", src)
    return src, set(mapped.values())


def load(ref, root, ports=(), subs=None, fresh=False):
    """One package's run of `tests/<ref>.py`, as a module (`fresh`: made
    anew, on a fresh draw of its ports)."""
    key = (ref, root)
    if fresh:
        _RUNS.pop(key, None)
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
        src, mod._ported_drawn = _source(ref, root, ports, subs or {})
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        _RUNS[key] = mod
    return _RUNS[key]


def _signature(fn, first=()):
    params = list(inspect.signature(fn).parameters.values())
    lead = params[:len(first)]
    return inspect.Signature(lead + [inspect.Parameter(
        "pkg", inspect.Parameter.POSITIONAL_OR_KEYWORD)] + params[len(first):])


def _attempts(run, redraw, drawn):
    """run(), again after redraw() while a bind in it finds one of the
    ports drawn() taken (PORT_ATTEMPTS runs in all; `redraw` None: once)."""
    for attempt in range(1, PORT_ATTEMPTS + 1):
        try:
            return run()
        except Exception as e:  # noqa: BLE001 — re-raised unless a port
            if (redraw is None or attempt == PORT_ATTEMPTS
                    or not _port_taken(e, drawn())):
                raise
        redraw()


def _case(fns, redraw=None):
    fn = fns[PACKAGES[1]]
    name = fn.__name__

    def case(pkg, **kw):
        def again():
            fns[pkg] = vars(redraw(pkg))[name]
        return _attempts(lambda: fns[pkg](**kw), redraw and again,
                         lambda: redraw.drawn(pkg))

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


def _method_case(classes, name, redraw=None):
    fn = getattr(classes[PACKAGES[1]], name)
    cls_name = classes[PACKAGES[1]].__name__

    def case(self, pkg, **kw):
        def again():  # the class of the fresh run, a fresh instance
            classes[pkg] = vars(redraw(pkg))[cls_name]
            self.__dict__.get("_ported", {}).pop(pkg, None)
        return _attempts(lambda: getattr(_instance(self, pkg), name)(**kw),
                         redraw and again, lambda: redraw.drawn(pkg))

    case.__signature__ = _signature(fn, first=("self",))
    case.__name__ = case.__qualname__ = name
    case.__doc__ = fn.__doc__
    case.pytestmark = list(getattr(fn, "pytestmark", []))
    return case


def _class_case(classes, name, methods=None, redraw=None):
    cls = classes[PACKAGES[1]]
    body = {"_ported_classes": classes, "__doc__": cls.__doc__}
    for attr, value in vars(cls).items():
        if attr.startswith("test") and callable(value):
            if methods is not None and attr not in methods:
                continue
            body[attr] = _method_case(classes, attr, redraw)
        elif hasattr(value, "_ported_fixture"):
            body[attr] = _fixture_of(
                {r: vars(c)[attr] for r, c in classes.items()}, attr,
                method=True)
    case = type(name, (), body)
    case.pytestmark = list(getattr(cls, "pytestmark", []))
    return case


class _Redraw:
    """A file's fresh draw of ports for one package's run (`redraw(root)`),
    and the ports that run now binds (`drawn(root)`)."""

    def __init__(self, ref, ports, subs):
        self.ref, self.ports, self.subs = ref, ports, subs

    def __call__(self, root):
        return load(self.ref, root, self.ports, self.subs, fresh=True)

    def drawn(self, root):
        return _RUNS[(self.ref, root)]._ported_drawn


def ported(ns, ref, only=None, ports=(), subs=None):
    """Put `tests/<ref>.py`'s cases (or those named in `only`) into `ns`
    as cases on both packages. An `only` entry "Class.test_name" takes
    that one method of the class (and the class's fixtures)."""
    runs = {root: load(ref, root, ports, subs) for root in PACKAGES}
    # a case whose port is taken reloads its package's run on a fresh draw
    # (the cases of a file without fixed ports have nothing to redraw)
    redraw = _Redraw(ref, ports, subs) if ports else None
    methods = {}
    if only is not None:
        for entry in only:
            cls_name, _, meth = entry.partition(".")
            if meth:
                methods.setdefault(cls_name, set()).add(meth)
        only = {entry.partition(".")[0] for entry in only}
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
            ns[name] = _class_case(objs, name, methods.get(name), redraw)
        elif inspect.isfunction(value) and name.startswith("test"):
            assert name not in ns, name
            ns[name] = _case(objs, redraw)
    ns.setdefault("pkg", _pkg)


@pytest.fixture(params=PACKAGES, name="pkg")
def _pkg(request):
    return request.param
