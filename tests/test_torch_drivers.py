"""The port's container drivers, run against the JAX package's.

Every case of `tests/test_docker_driver.py` (the docker factory through
the CLI shim in `tests/fake_docker/`, on addresses of its own:
`tests/fake_docker_port/`), `test_k8s_driver.py`,
`test_yarn_mesos_drivers.py`, `test_remote_factories.py` and
`test_factory_spi.py` on both packages (`pkg`; see
`tests/torch_ported_cases.py`). Besides: the invoker CLI of each package
accepts every factory name of its `FACTORY_PROVIDERS`, the two packages
name the same five, and every default of the port's SPI resolves inside
the port.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_ported_cases import PACKAGES, ported

ROOT = Path(__file__).resolve().parents[1]

#: the docker cases run the CLI shim through `tests/fake_docker_port/`,
#: whose containers take addresses of their own: the reference's docker
#: file may run the shim at the same time
_SHIM = [('/ "fake_docker")', '/ "fake_docker_port")'),
         ('startswith("127.77.0.")', 'startswith("127.78.")')]
ported(globals(), "test_docker_driver",
       subs={root: _SHIM for root in PACKAGES})
ported(globals(), "test_k8s_driver")
ported(globals(), "test_yarn_mesos_drivers")
ported(globals(), "test_remote_factories")
ported(globals(), "test_factory_spi", subs={root: _SHIM[:1]
                                            for root in PACKAGES})

_ACCEPTS = """
import sys
import {root}.invoker.__main__ as M
def run(coro):
    print("FACTORY", coro.cr_frame.f_locals["args"].container_factory)
    coro.close()
M.asyncio.run = run
sys.argv = ["invoker", "--db", "w.db", "--unique-name", "a",
            "--container-factory", sys.argv[1]]
M.main()
"""


def test_both_packages_name_the_same_five_factories():
    names = [list(importlib.import_module(
        f"{root}.containerpool.factory").FACTORY_PROVIDERS) for root in PACKAGES]
    assert names[0] == names[1] == ["process", "docker", "kubernetes",
                                    "yarn", "mesos"]


@pytest.mark.parametrize("factory", ["process", "docker", "kubernetes",
                                     "yarn", "mesos"])
def test_the_invoker_cli_accepts_every_factory_name(pkg, factory):
    """`--container-factory NAME` parses and reaches the boot (its
    `asyncio.run` stubbed) in each package's invoker main."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _ACCEPTS.format(root=pkg), factory],
        cwd=ROOT, env=dict(env, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("FACTORY ", 1)[1].split()[0] == factory


def test_every_default_of_the_port_spi_resolves_in_the_port():
    from openwhisk_tpu_torch import spi
    for name in spi.SPI_NAMES:
        path = spi._DEFAULTS[name]
        assert path.startswith("openwhisk_tpu_torch."), path
        mod, attr = path.split(":")
        assert hasattr(importlib.import_module(mod), attr), path
