"""auformer_torch/ops/build.py: the name of a built kernel library follows
every input of its build (source, shared headers, defines), so a changed
input is never served from an old build. Nothing here compiles."""
import shutil

import pytest

from auformer_torch.ops import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead of the checkout's."""
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    monkeypatch.setattr(build, "SRC_DIR", src)
    return src


def _append(path, text):
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("change", ["source", "header", "define"])
@pytest.mark.parametrize("name", build.KERNELS)
def test_library_name_follows_its_inputs(csrc, name, change):
    before = build._target(name)
    assert build._target(name) == before          # stable for one input
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"
    defines = ()
    if change == "source":
        _append(csrc / f"{name}.cu", "\n// edited\n")
    elif change == "header":
        _append(csrc / "hopper.cuh", "\n// edited\n")
    else:
        defines = ("SOME_SWITCH",)
    assert build._target(name, defines) != before


def test_other_kernels_keep_their_name_when_one_source_changes(csrc):
    before = {n: build._target(n) for n in build.KERNELS}
    _append(csrc / "mel.cu", "\n// edited\n")
    assert build._target("attention") == before["attention"]
    assert build._target("mel") != before["mel"]
