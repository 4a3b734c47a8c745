"""The port's redmax XML parser (``model/xml_parser.py``) against the JAX
package's, float64 on the CPU.

- Two scene files written here (with an OBJ mesh, a contact-point file and
  an abstract tactile spec beside them in ``tmp_path``) cover every tag and
  default the parser takes: ``<option>``, ``<solver_option>`` (max_iter 100
  and max_ls 20, clamped to 10 and 6), ``<ground>``, ``<default>`` (joint,
  motor, contact and tactile fallbacks), nested ``<robot>/<link>`` trees with
  every joint type, cuboid, sphere, cylinder, mesh (``OBJ_TO_WORLD`` and
  ``OBJ_TO_JOINT``) and abstract bodies, ground and general-primitive
  contacts, force and position motors, rect_array and abstract tactile
  sensors (the sensor's pos and quat composed into the body frame),
  ``<variable>`` and ``<virtual>``. The two parsers' ``SceneSpec`` are equal
  field by field, and the two builders' ``Structure`` equal and ``Model``
  leaves equal bit for bit.
- ``chip_smoke.write_scene_xml`` of the bundled scenes: RollingBall 8 x 8,
  TactilePush, StableGrasp and TactileInsertion parse back to the bundled
  scene exactly (every Structure field, every Model leaf), and the JAX
  parser reads the same files to the same spec. DClaw's fingertips carry
  explicit contact points on cylinder bodies and body-frame markers that
  are no rect_array grid, which the redmax schema cannot hold (it gives
  explicit points only to abstract bodies, and joint-frame markers only to
  abstract sensors); its file is checked against the JAX parser only.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import tree_diff, write_scene_xml
from tactilesimulation_tpu.model import builder as jax_builder
from tactilesimulation_tpu.model import xml_parser as jax_parser
from tactilesimulation_tpu_torch.model import builder, task_scenes, xml_parser

torch.set_num_threads(1)

EVERY_JOINT = """<redmax model="every_joint">
  <option integrator="BDF2" timestep="0.004" gravity="0 0 -9.81"/>
  <solver_option tol="1e-10" max_iter="100" max_ls="20"/>
  <ground pos="0 0 -0.01" normal="0 0 2"/>
  <default>
    <joint damping="0.5" lim_stiffness="20"/>
    <motor P="3" D="0.2"/>
    <general_primitive_contact kn="2e3" kt="3" mu="0.6" damping="0.7"/>
    <tactile kn="150" kt="2" mu="1.1" damping="0.05"/>
  </default>
  <robot>
    <link name="base">
      <joint name="slide" type="prismatic" axis="1 0 0" pos="0 0 0.3"
             lim="-0.1 0.1"/>
      <body name="slider" type="cuboid" size="0.04 0.03 0.02" density="800"
            general_contact_resolution="3 2 2"/>
      <link name="arm">
        <joint name="hinge" type="revolute" axis0="0 1 1" pos="0.05 0 0"
               quat="0.9 0.1 0 0" damping="1.5"/>
        <body name="rod" type="cylinder" radius="0.01" length="0.08"
              pos="0 0 -0.04" rgba="1 0 0 1"
              general_contact_angle_resolution="6"
              general_contact_radius_resolution="2"/>
        <link name="plate">
          <joint name="planar" type="planar" axis0="1 0 0" axis1="0 1 0"
                 pos="0 0 -0.08"/>
          <body name="pad" type="cuboid" size="0.03 0.03 0.004"
                general_contact_resolution="2 2 2"/>
        </link>
      </link>
    </link>
    <link name="xyz">
      <joint name="trans" type="translational" pos="0.2 0 0.1"/>
      <body name="ball" type="sphere" radius="0.015" density="500"/>
    </link>
    <link name="free_e">
      <joint name="free_e" type="free3d-exp" pos="-0.2 0 0.1"/>
      <body name="box_e" type="cuboid" size="0.02 0.02 0.02"
            general_contact_resolution="2 2 2"/>
      <link name="welded">
        <joint name="weld" type="fixed" pos="0 0.03 0"/>
        <body name="box_w" type="cuboid" size="0.01 0.01 0.01"/>
      </link>
    </link>
    <link name="free_u">
      <joint name="free_u" type="free3d-euler" pos="0 0.2 0.1"/>
      <body name="cap" type="cylinder" radius="0.02" length="0.01"/>
    </link>
  </robot>
  <contact>
    <ground_contact body="box_e" kn="5e3"/>
    <ground_contact body="slider"/>
    <general_primitive_contact general_body="pad" primitive_body="ball"
                               render="true"/>
    <general_primitive_contact general_body="rod" primitive_body="cap"
                               mu="0.9"/>
    <general_primitive_contact general_body="box_e" primitive_body="cap"/>
  </contact>
  <actuator>
    <motor joint="slide" ctrl="force" ctrl_range="-5 5"/>
    <motor joint="hinge" ctrl="position" P="20"/>
    <motor joint="planar" ctrl="force"/>
    <motor joint="trans" ctrl="position" D="0.5" ctrl_range="-1 1"/>
  </actuator>
  <sensor>
    <tactile name="skin" body="pad" type="rect_array" resolution="3 4"
             rect_pos0="-0.01 0.01 -0.002" rect_pos1="0.01 -0.01 -0.002"
             axis0="0 -1 0" axis1="1 0 0"/>
  </sensor>
</redmax>
"""

SENSORS = """<redmax model="sensors">
  <option integrator="BDF1" timestep="0.005"/>
  <ground/>
  <robot>
    <link name="frame">
      <joint name="base" type="revolute" axis="0 0 1" pos="0 0 0.1"/>
      <body name="housing" type="mesh" filename="housing.obj" density="300"
            transform_type="OBJ_TO_WORLD" pos="0 0 0.1"/>
      <link name="fing">
        <joint name="finger" type="prismatic" axis="0 0 1" pos="0 0 -0.02"
               lim="-0.05 0"/>
        <body name="finger_body" type="mesh" filename="housing.obj"
              density="500" transform_type="OBJ_TO_JOINT"/>
        <link name="tipl">
          <joint name="tip" type="fixed" pos="0 0 -0.03"/>
          <body name="tip_body" type="abstract" mass="0.02"
                inertia="1e-6 2e-6 3e-6" pos="0.001 0 0" quat="1 0 0 0">
            <collision contacts="tip_contacts.txt" pos="0 0 0.002"
                       quat="0.7071 0 0 0.7071"/>
          </body>
        </link>
      </link>
    </link>
    <link name="padl">
      <joint name="pad_joint" type="translational" pos="0 0 0.05"/>
      <body name="pad_body" type="cuboid" size="0.05 0.05 0.01"
            quat="0 1 0 0" pos="0 0 0.001" general_contact_resolution="4 4 2"/>
    </link>
    <link name="obj">
      <joint name="object" type="free3d-exp" pos="0 0 0.02"/>
      <body name="object" type="sphere" radius="0.02" density="1"/>
    </link>
  </robot>
  <contact>
    <ground_contact body="object" kn="5e3" kt="1" mu="0.8" damping="0.03"/>
    <general_primitive_contact general_body="tip_body"
                               primitive_body="object"/>
    <general_primitive_contact general_body="pad_body"
                               primitive_body="object"/>
  </contact>
  <actuator>
    <motor joint="pad_joint" ctrl="force" ctrl_range="-1 1"/>
    <motor joint="finger" ctrl="position" P="10" D="0.1"/>
  </actuator>
  <sensor>
    <tactile name="pad" body="pad_body" type="rect_array" resolution="5 4"
             rect_pos0="-0.02 0.02 -0.005" rect_pos1="0.02 -0.02 -0.005"
             axis0="0 -1 0" axis1="1 0 0" kn="1" kt="0.01" mu="2"
             damping="0.003"/>
    <tactile name="tip_skin" body="tip_body" type="abstract"
             spec="tip_tactile.txt" pos="0 0 0.001"
             quat="0.9239 0 0.3827 0" render="true"/>
  </sensor>
  <variable>
    <endeffector joint="tip" pos="0 0 -0.01" radius="0.002"/>
    <endeffector name="pad_center" joint="pad_joint"/>
  </variable>
  <virtual>
    <sphere name="goal" pos="0.1 0 0.02" quat="1 0 0 0" size="0.01 0.01 0.01"
            texture="goal.png"/>
  </virtual>
</redmax>
"""

CASES = {"every_joint": EVERY_JOINT, "sensors": SENSORS}

# bundled scenes for the writer: (constructor, whether the schema holds it)
BUNDLED = {
    "rolling_ball_8": (lambda **k: task_scenes.rolling_ball(8, **k), True),
    "tactile_push": (task_scenes.tactile_push, True),
    "stable_grasp": (task_scenes.stable_grasp, True),
    "tactile_insertion": (task_scenes.tactile_insertion, True),
    "dclaw": (task_scenes.dclaw, False),
}
# what the schema cannot hold of DClaw (the writer names each)
DCLAW_INEXACT = (
    [f"bodies[{b}].contact_points" for b in (4, 8, 12)]
    + [f"tactiles '{f}3_link_fingertip'" for f in ("one", "two", "three")])


def write_sidecars(where):
    """The OBJ mesh, the contact points and the abstract tactile spec the
    SENSORS scene names."""
    rng = np.random.RandomState(3)
    with open(os.path.join(where, "housing.obj"), "w") as fp:
        for v in np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                           for z in (-1, 1)]) * 0.01:
            fp.write("v {} {} {}\n".format(*v))
        fp.write("f 1 2 4 3\nf 5 6 8 7\n")
    pts = 0.004 * rng.randn(6, 3)
    with open(os.path.join(where, "tip_contacts.txt"), "w") as fp:
        fp.write(f"{len(pts)}\n")
        for p in pts:
            fp.write("{} {} {}\n".format(*p))
    n = 6
    nrm = rng.randn(n, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a0 = np.cross(nrm, [0.0, 0.0, 1.0])
    a0 /= np.linalg.norm(a0, axis=1, keepdims=True)
    with open(os.path.join(where, "tip_tactile.txt"), "w") as fp:
        fp.write(f"{n}\n")
        for i in range(n):
            p, nm, x0 = 0.005 * rng.randn(3), nrm[i], a0[i]
            x1 = np.cross(nm, x0)
            fp.write('"{} {} {}" "{} {}" "{} {} {}" "{} {} {}" "{} {} {}"\n'
                     .format(*p, i // 3, i % 3, *nm, *x0, *x1))


@pytest.fixture(params=sorted(CASES))
def scene_file(request, tmp_path):
    write_sidecars(tmp_path)
    path = tmp_path / f"{request.param}.xml"
    path.write_text(CASES[request.param])
    return str(path)


def builds_agree(spec_j, spec_t):
    """JAX builder.build against the port's: Structure equal, Model leaves
    equal in float64."""
    sj, mj = jax_builder.build(spec_j)
    st, mt = builder.build(spec_t)
    assert mt.dtype == torch.float64
    assert tree_diff(st, sj, "Structure") == []
    assert tree_diff(mt, mj, "Model") == []
    return st, mt


def test_parser_matches_jax(scene_file):
    spec_t = xml_parser.parse_scene(scene_file)
    spec_j = jax_parser.parse_scene(scene_file)
    assert tree_diff(spec_t, spec_j, "SceneSpec") == []
    if "every_joint" in scene_file:      # the clamps and the defaults
        assert (spec_t.solver_max_iter, spec_t.solver_max_ls) == (10, 6)
        assert [j.damping for j in spec_t.joints[:2]] == [0.5, 1.5]
        assert spec_t.motors[0].P == 3.0 and spec_t.tactiles[0].kn == 150.0
    else:
        assert {b.gtype for b in spec_t.bodies} == {0, 2, 3, 4}
        assert spec_t.tactiles[1].in_joint_frame and spec_t.virtuals


def test_build_matches_jax(scene_file):
    builds_agree(jax_parser.parse_scene(scene_file),
                 xml_parser.parse_scene(scene_file))


@pytest.mark.parametrize("name", sorted(BUNDLED))
def test_written_scene_parses_back(name, tmp_path):
    make, exact = BUNDLED[name]
    path = str(tmp_path / f"{name}.xml")
    inexact = write_scene_xml(make(spec_only=True), path, exact=exact)
    spec_t = xml_parser.parse_scene(path)
    assert tree_diff(spec_t, jax_parser.parse_scene(path),
                       "SceneSpec") == []
    if exact:
        st, mt = builds_agree(jax_parser.parse_scene(path), spec_t)
        s_ref, m_ref = make()
        assert tree_diff(st, s_ref, "Structure") == []
        assert tree_diff(mt, m_ref, "Model") == []
    else:
        assert [x.split(":")[0] for x in inexact
                if "rows/cols" not in x] == DCLAW_INEXACT
        with pytest.raises(ValueError, match="one3_link"):
            builder.build(spec_t)


def test_writer_refuses_what_it_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match=r"bodies\[4\].contact_points"):
        write_scene_xml(task_scenes.dclaw(spec_only=True),
                        str(tmp_path / "dclaw.xml"))
