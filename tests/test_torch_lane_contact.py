"""K1 and K1T, the pair-wrench op (``ops/lane_contact.py``), against the JAX
package.

On the CPU the port's op runs its plain PyTorch version, so these tests pin
that version (the one the card's kernels are held to in ``chip_smoke.py``)
against the JAX package's Pallas kernel in interpret mode and its jnp twin:

- float32 against the Pallas kernel and the jnp twin, to 3e-6 x scale (the
  bar of tests/test_lane_contact.py: f32 round-off, other summation order);
- float64 against the jnp twin, to 1e-10 x scale, with static and per-lane
  (K, 4, B) contact parameters;
- the backward (a VJP through the plain twin) against ``jax.vjp``, float64;
- ``contact_terms_fused`` against the plain ``lanes.contact_terms``.

Inputs are the contact-rich lane states that ``chip_smoke.py`` holds the
card's kernel to, made from a numpy seed: the pad presses into the box and
the box into the ground (TactilePush: ground and cuboid); the pad presses
onto the ball (RollingBall, 8x8 markers: sphere); a tilted cube presses onto
a cylinder (a hand-made scene: cylinder).

The CUDA source itself (``csrc/lane_contact.cu``), built as host C++ by
``megastep_host.HostLaneContact`` and run in float64 through the op's own
wrapper, is held to the JAX package on five scenes (StableGrasp's markers
in up to 11 segments, TactileInsertion with per-lane parameters too),
with points exactly on the contact law's kinks (``chip_smoke.
pair_wrench_inputs(tie=True)``): K1 to the jnp twin and K1T to ``jax.vjp``
of it, to 1e-10 x scale. JAX's twin runs jitted one segment at a time (the
twin is a sum over segments; the whole twin of StableGrasp takes minutes
to compile and minutes eagerly). The kernels themselves are tested on the
card by tests/test_torch_cuda.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import megastep_host
from chip_smoke import (K1_SCENES, contact_state, cylinder_probe,
                        pair_wrench_inputs)
from tactilesimulation_tpu.model import task_scenes as jax_scenes
from tactilesimulation_tpu.ops import lane_contact as jax_lc
from tactilesimulation_tpu.sim import contact as jax_contact
from tactilesimulation_tpu.sim import lanes as jax_lanes
from tactilesimulation_tpu_torch.model import task_scenes as torch_scenes
from tactilesimulation_tpu_torch.ops import lane_contact as torch_lc
from tactilesimulation_tpu_torch.sim import contact as torch_contact
from tactilesimulation_tpu_torch.sim import lanes as torch_lanes

torch.set_num_threads(1)

B = 4
SCENES = {
    "tactile_push": lambda m: m.tactile_push(),
    "rolling_ball_8": lambda m: m.rolling_ball(resolution=8),
    "cylinder_probe": cylinder_probe,
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    name = request.param
    sj, mj = SCENES[name](jax_scenes)
    st, mt = SCENES[name](torch_scenes)
    q, v = contact_state(name, mt.q_init.numpy(), B, seed=0)
    # op inputs from the port's small stage, float64; both sides get them
    jp, jq, bp, bquat, _, _, _, Om, be = torch_lanes._fused_small_stage(
        st, mt, torch.as_tensor(q), torch.as_tensor(v))
    pw_t, meta = torch_lc.make_pair_wrenches(st)
    params = torch_contact.combined_params(mt)
    xi = torch_lc.pack_points(st, mt, meta[2])
    args = [a.numpy() for a in (jp, jq, Om, be, bp, bquat, mt.body_size,
                                params, mt.ground_pos, mt.ground_normal, xi)]
    rng = np.random.RandomState(1)
    per_lane = params.numpy()[:, :, None] * rng.uniform(0.5, 1.5,
                                                        params.shape + (B,))
    return dict(name=name, sj=sj, mj=mj, st=st, mt=mt, q=q, v=v, args=args,
                per_lane=per_lane, pw_t=pw_t)


def _with_params(sc, per_lane):
    args = list(sc["args"])
    if per_lane:
        args[7] = sc["per_lane"]
    return args


def _assert_close(got, want, tol, what):
    for g, w, name in zip(got, want, ("F", "Tau", "tac")):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        if w.size == 0:       # a scene without tactile markers
            continue
        scale = float(np.max(np.abs(w))) + 1e-6
        err = float(np.max(np.abs(g - w)))
        assert err <= tol * scale, (what, name, err, scale)


def test_contacts_are_active(scene):
    F, Tau, tac = scene["pw_t"](*[torch.as_tensor(a)
                                  for a in scene["args"]])
    assert float(torch.max(torch.abs(F))) > 1e-3
    if tac.numel():
        assert float(torch.max(torch.abs(tac))) > 1e-3


@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
def test_f32_matches_pallas_kernel_and_twin(scene, per_lane):
    args = [np.asarray(a, np.float32) for a in _with_params(scene, per_lane)]
    pw_j, _ = jax_lc.make_pair_wrenches(scene["sj"], interpret=True)
    want_kernel = pw_j(*[jnp.asarray(a) for a in args])
    want_twin = pw_j.reference(*[jnp.asarray(a) for a in args])
    got = scene["pw_t"](*[torch.as_tensor(a) for a in args])
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close(got, want_kernel, 3e-6, "kernel")
    _assert_close(got, want_twin, 3e-6, "twin")
    assert scene["pw_t"].launches == 0     # the CPU route launches nothing


@pytest.mark.parametrize("per_lane", [False, True], ids=["static", "lanes"])
def test_f64_matches_jax_twin(scene, per_lane):
    args = _with_params(scene, per_lane)
    pw_j, _ = jax_lc.make_pair_wrenches(scene["sj"], interpret=True)
    want = pw_j.reference(*[jnp.asarray(a) for a in args])
    got = scene["pw_t"](*[torch.as_tensor(a) for a in args])
    _assert_close(got, want, 1e-10, "twin f64")


def test_vjp_matches_jax(scene):
    args = _with_params(scene, True)
    pw_j, _ = jax_lc.make_pair_wrenches(scene["sj"], interpret=True)
    outs, pullback = jax.vjp(pw_j.reference, *[jnp.asarray(a) for a in args])
    rng = np.random.RandomState(2)
    cots = [rng.randn(*o.shape) for o in outs]
    want = pullback(tuple(jnp.asarray(c) for c in cots))

    ins = [torch.as_tensor(a).requires_grad_() for a in args]
    got_outs = scene["pw_t"](*ins)
    got = torch.autograd.grad(got_outs, ins,
                              [torch.as_tensor(c) for c in cots],
                              allow_unused=True)
    for g, w, name in zip(got, want, torch_lc._ARG_NAMES):
        w = np.asarray(w)
        if g is None:          # an input no segment reads (gpos w/o ground)
            assert not np.any(w), name
            continue
        scale = float(np.max(np.abs(w))) + 1e-12
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= 1e-10 * scale, (name, err, scale)


def test_contact_terms_fused_matches_jax_contact_terms(scene):
    sj, mj, st, mt = scene["sj"], scene["mj"], scene["st"], scene["mt"]
    q, v = scene["q"], scene["v"]
    Qj, tacj = jax_lanes.contact_terms(sj, mj, jnp.asarray(q), jnp.asarray(v))
    pw, meta = torch_lc.make_pair_wrenches(st)
    Qt, tact = torch_lanes.contact_terms_fused(
        st, mt, torch.as_tensor(q), torch.as_tensor(v), pw, meta)
    # the plain group loop (the port's own oracle) agrees as well
    Qp, tacp = torch_lanes.contact_terms(st, mt, torch.as_tensor(q),
                                         torch.as_tensor(v))
    for g, w, name in ((Qt, Qj, "Q"), (tact, tacj, "tac"), (Qp, Qj, "Q plain"),
                       (tacp, tacj, "tac plain")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if w.size == 0:
            continue
        scale = float(np.max(np.abs(w)))
        assert scale > 1e-6, name
        assert float(np.max(np.abs(g.numpy() - w))) <= 1e-10 * scale, name


def test_chord_jacobian_recomputes_twin_once():
    """The chord factor's n pullbacks share ONE twin recompute."""
    st, mt = torch_scenes.tactile_push()
    q, v = contact_state("tactile_push", mt.q_init.numpy(), B, seed=3)
    q, v = torch.as_tensor(q), torch.as_tensor(v)
    pw, meta = torch_lc.make_pair_wrenches(st)
    residual = torch_lanes.make_residual(st, (pw, meta))
    inputs = torch_lanes.StepInputs(
        model=mt, u=torch.zeros(st.ndof_u, B, dtype=torch.float64),
        q_base=q, p_base=torch_lanes.momentum(st, mt, q, v),
        gamma=mt.h.reshape(1, 1))
    torch_lanes.make_chord_lu(residual, inputs, v)
    assert (pw.launches, pw.twin_vjps, pw.twin_recomputes) == \
        (0, st.ndof_q, 1)


def test_jax_combined_params_match(scene):
    want = np.asarray(jax_contact.combined_params(scene["mj"]))
    np.testing.assert_array_equal(scene["args"][7], want)


# -- the CUDA source on the host, against JAX ---------------------------------

HOST_B = 4
HOST_CASES = [("tactile_push", False), ("stable_grasp", False), ("tactile_insertion", False),
              ("tactile_insertion", True), ("rolling_ball_8", False),
              ("cylinder_probe", False)]
_JAX_SEGMENT_VJP = {}


def _jax_by_segment(op, args, cots):
    """JAX's twin and its VJP, one segment at a time: each segment runs as
    a scene of its own (its joints, body and parameter row renumbered) and
    its outputs and cotangents are added back in place."""
    jp, jq, Om, be, bp, bquat, sizes, params, gpos, gn, xi = args
    gF, gT, gtac = cots
    B = jp.shape[-1]
    outs = [np.zeros((3, op.J, B)), np.zeros((3, op.J, B)),
            np.zeros((3, op.ntac, B))]
    grads = [np.zeros_like(a) for a in args]
    off = 0
    for s in op.segments:
        prim = s.gtype >= 0
        jj = [s.joint] + ([s.prim_joint] if prim else [])
        bb = [s.prim_body] if prim else [0]
        tac = s.tac0 >= 0
        rows = slice(s.tac0, s.tac0 + s.n) if tac else slice(0, 0)
        seg = jax_lc.Segment(row0=0, n=s.n, n_pad=s.n_pad, src0=0, joint=0,
                             prim_body=0 if prim else -1,
                             prim_joint=1 if prim else -1, gtype=s.gtype,
                             param_row=0, tac0=0 if tac else -1)
        key = (seg, len(jj), params.ndim)
        if key not in _JAX_SEGMENT_VJP:
            ref = lambda *a, seg=seg, nj=len(jj), nt=s.n if tac else 0: (
                jax_lc._wrenches_ref((seg,), nj, nt, *a))

            def vjp(a, c, ref=ref):
                o, pullback = jax.vjp(ref, *a)
                return o, pullback(c)

            _JAX_SEGMENT_VJP[key] = jax.jit(vjp)
        xi_rows = np.zeros((s.n_pad, 3))
        xi_rows[:s.n] = xi[off:off + s.n]
        sub = (jp[:, jj], jq[:, jj], Om[:, jj], be[:, jj], bp[:, bb],
               bquat[:, bb], sizes[bb], params[[s.param_row]], gpos, gn,
               xi_rows)
        c = (gF[:, jj], gT[:, jj], gtac[:, rows])
        o, g = _JAX_SEGMENT_VJP[key](tuple(jnp.asarray(a) for a in sub),
                                     tuple(jnp.asarray(a) for a in c))
        o, g = [np.asarray(x) for x in o], [np.asarray(x) for x in g]
        outs[0][:, jj] += o[0]
        outs[1][:, jj] += o[1]
        outs[2][:, rows] += o[2]
        for i, idx in ((0, jj), (1, jj), (2, jj), (3, jj)):
            grads[i][:, idx] += g[i]
        if prim:
            grads[4][:, bb] += g[4]
            grads[5][:, bb] += g[5]
            grads[6][bb] += g[6]
        grads[7][[s.param_row]] += g[7]
        grads[8] += g[8]
        grads[9] += g[9]
        grads[10][off:off + s.n] += g[10][:s.n]
        off += s.n
    return outs, grads


@pytest.fixture(scope="module", params=HOST_CASES,
                ids=[f"{n}-{'lanes' if p else 'static'}"
                     for n, p in HOST_CASES])
def host_case(request):
    name, per_lane = request.param
    op, args, lanes_prm = pair_wrench_inputs(name, HOST_B, tie=True)
    if per_lane:
        args[7] = lanes_prm
    rng = np.random.RandomState(2)
    cots = [rng.randn(3, n, HOST_B) for n in (op.J, op.J, op.ntac)]
    want_out, want_grad = _jax_by_segment(op, [a.numpy() for a in args],
                                          cots)
    host = megastep_host.HostLaneContact(op)
    got_out = host.forward(*args)
    got_grad = host.adjoint(args, [torch.as_tensor(c) for c in cots])
    return dict(name=name, want_out=want_out, want_grad=want_grad,
                got_out=got_out, got_grad=got_grad)


def test_host_k1_matches_jax_twin(host_case):
    """F, T and the tactile rows, a marker in several segments summed over
    them (StableGrasp)."""
    _assert_close(host_case["got_out"], host_case["want_out"], 1e-10,
                  f"host K1 {host_case['name']}")
    assert float(np.max(np.abs(host_case["want_out"][0]))) > 1e-3


def test_host_k1t_matches_jax_vjp(host_case):
    for g, w, what in zip(host_case["got_grad"], host_case["want_grad"],
                          torch_lc._ARG_NAMES):
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g.numpy() - w)))
        assert err <= 1e-10 * scale, (host_case["name"], what, err, scale)
        if what in ("jp", "bp", "params"):
            assert scale > 0, what


def test_host_k1t_holds_the_primitive_point_fixed():
    """K1T takes the primitive side's torque at the point held fixed in the
    primitive's frame (the twin's and JAX's lanes convention), not at the
    moving contact point (the megastep's): where the pad touches the box,
    the two conventions' cotangents part, and K1T follows the first."""
    op, args, _ = pair_wrench_inputs("tactile_push", HOST_B, tie=True)
    rng = np.random.RandomState(3)
    cots = [torch.as_tensor(rng.randn(3, n, HOST_B))
            for n in (op.J, op.J, op.ntac)]

    def moving_point_twin(*a):
        """The twin, segment by segment, with each primitive joint's torque
        taken at the moving point: minus the owner's sum of x x f."""
        xi_rows = a[10].new_zeros((op.n_rows, 3)).index_copy(
            0, torch.as_tensor(op.packed_rows), a[10])
        outs = [0, 0, 0]
        for sg in op.segments:
            F, T, tac = torch_lc.wrenches_ref([sg], op.J, op.ntac, *a[:10],
                                              xi_rows)
            if sg.gtype != torch_lc.GROUND:
                assert sg.joint != sg.prim_joint
                onto = torch.zeros(op.J, dtype=T.dtype)
                onto[sg.prim_joint] = 1.0
                T = T - onto[None, :, None] * (T[:, sg.prim_joint]
                                               + T[:, sg.joint])[:, None]
            outs = [o + x for o, x in zip(outs, (F, T, tac))]
        return outs

    def twin_vjp(twin):
        ins = [a.clone().requires_grad_() for a in args]
        return torch.autograd.grad(twin(*ins), ins, cots, allow_unused=True)

    got = megastep_host.HostLaneContact(op).adjoint(args, cots)
    fixed, moving = twin_vjp(op.reference), twin_vjp(moving_point_twin)
    for f, m in zip(op.reference(*args), moving_point_twin(*args)):
        assert float((f - m).abs().max()) <= 1e-12 * float(f.abs().max())
    for name in ("jp", "jq", "bp", "bquat"):
        i = torch_lc._ARG_NAMES.index(name)
        scale = float(fixed[i].abs().max())
        assert float((got[i] - fixed[i]).abs().max()) <= 1e-10 * scale
        assert float((got[i] - moving[i]).abs().max()) >= 1e-3 * scale, name


def test_host_k1t_computes_what_is_asked():
    """Only the cotangents asked for come back; a cotangent of None counts
    as zero."""
    op, args, lanes_prm = pair_wrench_inputs("tactile_insertion", HOST_B)
    args[7] = lanes_prm
    rng = np.random.RandomState(4)
    gF, gT = (torch.as_tensor(rng.randn(3, op.J, HOST_B)) for _ in range(2))
    host = megastep_host.HostLaneContact(op)
    full = host.adjoint(args, [gF, gT, torch.zeros(3, op.ntac, HOST_B,
                                                    dtype=torch.float64)])
    need = (False, True, False, False, True, False, True, True, False,
            False, True)
    some = host.adjoint(args, [gF, gT, None], need)
    for nd, g, w in zip(need, some, full):
        assert (g is None) == (not nd)
        if nd:
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["stable_grasp", "tactile_insertion"])
def test_host_count_is_what_the_function_needs(name):
    """The operation count behind the kernels' bounds is the function's, not
    the decomposition's: the same when the segments are dealt in reverse
    (the blocks then stage other runs of segments' frames) and when the
    scene gains joints that no segment rotates; K1T asked for fewer
    cotangents counts less."""
    op, args, _ = pair_wrench_inputs(name, HOST_B)
    rng = np.random.RandomState(5)
    cots = [torch.as_tensor(rng.randn(3, n, HOST_B))
            for n in (op.J, op.J, op.ntac)]
    need = (True,) * 6 + (False,) * 5
    counts = megastep_host.HostLaneContact(op).count(args, cots, need)

    def variant(segments, J):
        v = copy.copy(op)
        v.segments, v.J, v._shapes, v._dev = segments, J, {}, {}
        v.plan = torch_lc.build_plan(segments)
        v.header = v.plan[:torch_lc.HEADER].copy()
        return megastep_host.HostLaneContact(v)

    offs = np.cumsum([0] + [sg.n for sg in op.segments])
    order = range(len(op.segments) - 1, -1, -1)
    rev = list(args)
    rev[10] = torch.cat([args[10][offs[i]:offs[i + 1]] for i in order])
    assert variant(tuple(op.segments[i] for i in order), op.J).count(
        rev, cots, need) == counts
    pad = lambda t: torch.cat([t, torch.as_tensor(
        rng.randn(t.shape[0], 2, HOST_B))], dim=1)
    wide = [pad(a) for a in args[:4]] + list(args[4:])
    assert variant(op.segments, op.J + 2).count(
        wide, [pad(c) for c in cots[:2]] + cots[2:], need) == counts
    every = megastep_host.HostLaneContact(op).count(args, cots)
    assert every[0] == counts[0] and every[1] > counts[1]


@pytest.mark.parametrize("name", K1_SCENES)
def test_plan_deals_every_point_once(name):
    """build_plan: pieces of at most CH points of one segment cover every
    point once; the rounds hold every piece; a repeated marker's entries
    run in segment order; NS is a power of two up to the cluster limit."""
    op = pair_wrench_inputs(name, 1)[0]
    plan, hdr = op.plan, op.header
    S, NP, NS, R, _, nrep, nrep_pts = (int(v) for v in hdr[:7])
    seg = plan[hdr[7]:hdr[7] + 8 * S].reshape(S, 8)
    piece = plan[hdr[8]:hdr[8] + 6 * NP].reshape(NP, 6)
    assert NS in (1, 2, 4, 8) and R * NS * torch_lc.WARPS >= NP
    seen = np.zeros(op.nsum, int)
    for si, x0, n, trow, rep0, _ in piece:
        assert 1 <= n <= torch_lc.CH
        assert seg[si, 0] <= x0 and x0 + n <= seg[si, 0] + seg[si, 1]
        seen[x0:x0 + n] += 1
        assert (trow >= 0) == (seg[si, 7] >= 0)
        assert rep0 < 0 or trow >= 0
    assert np.all(seen == 1)
    rep = plan[hdr[11]:hdr[11] + 3 * nrep].reshape(nrep, 3)
    idx = plan[hdr[12]:hdr[12] + nrep_pts]
    owner = {}                      # scratch point -> its segment
    for si, _, n, _, rep0, _ in piece:
        if rep0 >= 0:
            owner.update({rep0 + k: si for k in range(n)})
    for row, e0, cnt in rep:
        segs = [owner[i] for i in idx[e0:e0 + cnt]]
        assert cnt > 1 and segs == sorted(segs)
    if name == "stable_grasp":
        assert nrep == 260 and rep[:, 2].max() == 11
