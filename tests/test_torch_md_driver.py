"""The native MD driver's torch-free core (``allegro_tpu_torch/csrc/
md_core.cpp``, built by ``native/md_driver.py:build_md_core`` with plain
``g++`` in seconds), on the CPU.

``--selftest`` runs what JAX's driver's ``selftest()`` runs, on the port's
code: the npy and zip round trip, the sentinel-padded center-sorted list
of the cell list, the ghost rows refreshed from moved owners (each ghost
edge at its minimum-image length) and their force collapse, and the NVE
drift of velocity Verlet on a harmonic dimer. The driver itself links
libtorch's CUDA runner and the kernels, so it is built and run on the card
(``chip_smoke.py`` phase 9c).
"""

import shutil
import subprocess

import pytest

from allegro_tpu_torch.native import build_md_core
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_md_core(tmp_path_factory.mktemp("build"))


def test_core_builds_and_selftests(binary, tmp_path):
    run = subprocess.run([str(binary), "--selftest"], capture_output=True, text=True, timeout=120,
                         env={"TMPDIR": str(tmp_path)})
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "selftest OK"
    assert not list(tmp_path.glob("*.npy"))  # the round trip's file is removed


def test_core_refuses_to_run_a_package(binary):
    run = subprocess.run([str(binary), "--artifact", "model.pt2"], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode != 0 and "selftest only" in run.stderr


def test_failed_build_raises(tmp_path, monkeypatch):
    from allegro_tpu_torch.native import md_driver

    bad = tmp_path / "csrc"
    bad.mkdir()
    for name in (*md_driver.CORE_SOURCES, "md_core.h"):
        (bad / name).write_text((md_driver.CSRC / name).read_text())
    (bad / "md_core.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(md_driver, "CSRC", bad)
    with pytest.raises(RuntimeError, match="build failed"):
        build_md_core(tmp_path / "build")
