"""The port's binding of the native model compiler (``model/native.py``),
g++-built into the package's build directory, against the port's parser
and builder on the same files, by the JAX package's
``tests/test_native_compiler.py`` checks (``chip_smoke.native_mismatches``):
counts, dof layout, names, masses, inertias, body frames, point clouds,
markers and the per-dof motor count. The files: the two XML scenes of
``test_torch_xml_parser.py`` and ``chip_smoke.write_scene_xml`` of four
bundled scenes. A failed compile and a failed build raise.
"""

import os

import pytest

from chip_smoke import native_mismatches, write_scene_xml
from tactilesimulation_tpu_torch.model import (builder, native, task_scenes,
                                               xml_parser)
from tactilesimulation_tpu_torch.ops import _build
from test_torch_xml_parser import CASES, write_sidecars

BUNDLED = {
    "rolling_ball_8": lambda: task_scenes.rolling_ball(8, spec_only=True),
    "tactile_push": lambda: task_scenes.tactile_push(spec_only=True),
    "stable_grasp": lambda: task_scenes.stable_grasp(spec_only=True),
    "tactile_insertion": lambda: task_scenes.tactile_insertion(
        spec_only=True),
}


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    where = tmp_path_factory.mktemp("native")
    write_sidecars(where)
    out = {}
    for name, xml in CASES.items():
        (where / f"{name}.xml").write_text(xml)
        out[name] = str(where / f"{name}.xml")
    for name, spec in BUNDLED.items():
        out[name] = str(where / f"{name}.xml")
        assert write_scene_xml(spec(), out[name]) == []
    return out


@pytest.mark.parametrize("name", sorted(CASES) + sorted(BUNDLED))
def test_native_matches_parser(name, scene_files):
    path = scene_files[name]
    nm = native.compile_scene(path)
    struct, model = builder.build(xml_parser.parse_scene(path))
    assert native_mismatches(nm, struct, model) == []
    assert os.path.dirname(native.LIBRARY) == _build.BUILD
    assert os.path.exists(native.LIBRARY)


def test_native_compile_error_raises(tmp_path):
    bad = tmp_path / "bad.xml"
    bad.write_text('<redmax><robot><link><joint name="j" type="revolute"/>'
                   '<body name="b" type="torus"/></link></robot></redmax>')
    with pytest.raises(RuntimeError, match="torus"):
        native.compile_scene(str(bad))


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.build_native(force=True)
    assert not os.path.exists(tmp_path / "lib.so")
