"""The ported cases' port draw (`tests/torch_ported_cases.py`).

Two workers that draw the same port collide at the standalone's bind
(errno 98): a port drawn by binding port 0 and closing the socket lies in
the kernel's ephemeral range, where any outgoing connection or port-0
bind of another process may take it before the standalone binds it. The
helper draws below that range, each port free to bind at the draw, keeps
a literal one past another listed one one past it, and reruns a case on a
fresh draw when its bind of a drawn port still finds the port taken.
"""
import errno
import re
import socket

import pytest

from tests import torch_ported_cases as PC
from tests.torch_loadgen_cases import PORTS, SUBS

#: the reference file whose fixed ports the port's harness cases map
HARNESS = "test_performance_harness"
HARNESS_PORTS = PORTS[HARNESS]


def _mapped(src_ref, src_port, lit):
    """The number that `lit`'s first use became in the mapped source."""
    ref_lines = src_ref.splitlines()
    port_lines = src_port.splitlines()
    for a, b in zip(ref_lines, port_lines):
        if re.search(rf"\b{lit}\b", a):
            diff = [y for x, y in zip(re.findall(r"\d+", a),
                                      re.findall(r"\d+", b)) if x == lit]
            return int(diff[0])
    raise AssertionError(f"{lit} not in the source")


@pytest.mark.parametrize("root", PC.PACKAGES)
def test_ports_are_drawn_below_the_ephemeral_range_and_stay_consecutive(
        root):
    ref = (PC.TESTS / f"{HARNESS}.py").read_text()
    if root != PC.PACKAGES[0]:
        ref = re.sub(r"\bopenwhisk_tpu\b", root, ref)
    src, drawn = PC._source(HARNESS, root, HARNESS_PORTS, {})
    got = {lit: _mapped(ref, src, lit) for lit in HARNESS_PORTS}
    lo = PC.DRAW_RANGE[0]
    hi = min(PC.DRAW_RANGE[1], PC._ephemeral_low())
    assert all(lo <= p < hi for p in got.values()), got
    assert [got[str(13441 + i)] for i in range(4)] == [
        got["13441"] + i for i in range(4)]
    for lit in HARNESS_PORTS:
        assert not re.search(rf"\b{lit}\b", src), lit
    assert drawn == set(got.values())


def test_a_drawn_block_is_free_to_bind():
    base = PC._free_block(3)
    for p in range(base, base + 3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))


#: a run's drawn ports in the cases below
DRAWN = {24601, 24602}
_BIND = "error while attempting to bind on address ('127.0.0.1', {}): " \
        "address already in use"


@pytest.mark.parametrize("exc,taken", [
    (OSError(errno.EADDRINUSE, _BIND.format(24601)), True),
    (RuntimeError("standalone exited: [Errno 98] " + _BIND.format(24602)),
     True),
    (OSError(errno.EADDRINUSE, _BIND.format(46037)), False),
    (OSError(errno.EADDRINUSE, "Address already in use"), False),
    (RuntimeError("[Errno 98] the code under test's own text"), False),
    (OSError(errno.ECONNREFUSED, "Connect call failed ('127.0.0.1', "
                                 "24601)"), False),
    (AssertionError("books not clean"), False)], ids=[
    "oserror", "message", "another-port", "no-port", "text", "refused",
    "assertion"])
def test_a_taken_port_is_told_apart_from_other_failures(exc, taken):
    """Only an EADDRINUSE that names one of the run's drawn ports is a
    taken port; any other failure fails the case on its first run."""
    assert PC._port_taken(exc, DRAWN) is taken
    try:
        try:
            raise exc
        except Exception as inner:
            raise RuntimeError("the run failed") from inner
    except RuntimeError as outer:
        assert PC._port_taken(outer, DRAWN) is taken


def test_a_case_reruns_on_a_fresh_draw_only_while_its_port_is_taken():
    calls, draws = [], []

    def taken():
        return OSError(errno.EADDRINUSE, _BIND.format(24601))

    def drawn():
        return DRAWN

    def taken_then_ok():
        calls.append(1)
        if len(calls) < PC.PORT_ATTEMPTS:
            raise taken()
        return "ok"

    assert PC._attempts(taken_then_ok, lambda: draws.append(1),
                        drawn) == "ok"
    assert (len(calls), len(draws)) == (PC.PORT_ATTEMPTS,
                                        PC.PORT_ATTEMPTS - 1)

    calls.clear()

    def always_taken():
        calls.append(1)
        raise taken()

    with pytest.raises(OSError):
        PC._attempts(always_taken, lambda: None, drawn)
    assert len(calls) == PC.PORT_ATTEMPTS

    calls.clear()

    def fails():
        calls.append(1)
        raise AssertionError("a real failure")

    with pytest.raises(AssertionError):
        PC._attempts(fails, lambda: None, drawn)
    assert len(calls) == 1

    calls.clear()

    def another_port_taken():
        calls.append(1)
        raise OSError(errno.EADDRINUSE, _BIND.format(46037))

    with pytest.raises(OSError):
        PC._attempts(another_port_taken, lambda: None, drawn)
    assert len(calls) == 1


def test_a_taken_port_reruns_the_ported_case_on_a_fresh_run(monkeypatch):
    """A class case of the harness file whose first run finds one of its
    drawn ports taken (a stand-in for the method raises EADDRINUSE naming
    the port) passes on the rerun, which loads the package's run anew on a
    fresh draw."""
    ns = {}
    PC.ported(ns, HARNESS, only=("TestSimulations.test_threshold_violation_"
                                 "fails",), ports=HARNESS_PORTS,
              subs=SUBS[HARNESS])
    cls = ns["TestSimulations"]
    first = cls._ported_classes["openwhisk_tpu"]
    seen = []

    port = min(PC.load(HARNESS, "openwhisk_tpu")._ported_drawn)

    def fake(self, **_kw):
        seen.append(type(self))
        if len(seen) == 1:
            raise OSError(errno.EADDRINUSE, _BIND.format(port))

    monkeypatch.setattr(first, "test_threshold_violation_fails", fake)
    reloads = []
    real = PC.load

    def load(*a, **kw):
        mod = real(*a, **kw)
        if kw.get("fresh"):
            reloads.append(mod)
            monkeypatch.setattr(mod.TestSimulations,
                                "test_threshold_violation_fails", fake)
        return mod

    monkeypatch.setattr(PC, "load", load)
    cls().test_threshold_violation_fails(pkg="openwhisk_tpu")
    assert len(seen) == 2 and len(reloads) == 1
    assert seen[0] is first and seen[1] is reloads[0].TestSimulations
