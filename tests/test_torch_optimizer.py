"""repro_torch's optimizers (SGD, AdamW with float32 and bfloat16 moments,
Adafactor) against the JAX package's, fed the same numpy gradients.

Both start from the same parameters and, through
``convert.opt_state_from_numpy``, from the same state: at step 0, or after
two of the JAX package's steps (so that the bias corrections and
Adafactor's decay are past their first values). Then five steps each.
Tolerances: float32 parameters and state rtol = atol = 1e-6 (the two
packages' reductions add in different orders; the global norm and
Adafactor's means move by an ulp); bfloat16 moments one bfloat16 ulp (a
value an ulp of float32 from a rounding boundary may round either way);
``step`` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as j_opt
from repro_torch import convert
from repro_torch.train import optimizer as t_opt
from repro_torch.train.tree import flatten_up_to, tree_leaves, tree_map, tree_unflatten

CASES = [("sgd", "float32"), ("adamw", "float32"), ("adamw", "bfloat16"),
         ("adafactor", "float32")]
TOL = dict(rtol=1e-6, atol=1e-6)


def make_params(rng):
    """A dict, a list, a None, a 3-D leaf and a (1, n) leaf (not factored)."""
    f = lambda *s: np.asarray(rng.standard_normal(s), np.float32)  # noqa: E731
    return {"dense": {"w": f(6, 5), "b": f(5)},
            "layers": [f(2, 3, 4), None, f(1, 7)],
            "scale": f()}


def grads_like(rng, params, norm):
    """Random gradients scaled to global norm ``norm``."""
    g = tree_map(lambda p: np.asarray(rng.standard_normal(p.shape), np.float32), params)
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in tree_leaves(g)))
    return tree_map(lambda x: (x * (norm / total)).astype(np.float32), g)


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_jax(tree):
    return tree_map(jnp.asarray, tree)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bf16_ulp(x):
    a = np.abs(x.astype(np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


def assert_close(got, want, what):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if want.dtype.name == "bfloat16":
        w = want.astype(np.float32)
        assert (np.abs(got - w) <= bf16_ulp(w)).all(), what
    elif want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def assert_same_state(t_state, j_state):
    """Leaf by leaf, in flatten order, with the same dtypes."""
    t_leaves, j_leaves = tree_leaves(t_state), jax.tree_util.tree_leaves(j_state)
    assert len(t_leaves) == len(j_leaves)
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, i
        assert tuple(t.shape) == j.shape, i
        assert_close(t, j, f"leaf {i}")


@pytest.mark.parametrize("start", [0, 2])
@pytest.mark.parametrize("name,moments", CASES, ids=lambda v: v)
def test_optimizer_matches_jax(name, moments, start):
    rng = np.random.default_rng(0)
    params = make_params(rng)
    cfg = dict(name=name, lr=0.05, moment_dtype=moments, weight_decay=0.01, grad_clip=1.0)
    j_init, j_update = j_opt.make(j_opt.OptConfig(**cfg))
    t_init, t_update = t_opt.make(t_opt.OptConfig(**cfg))
    jp = to_jax(params)
    js = j_init(jp)
    for _ in range(start):  # a mid-training state, carried across
        jp, js = j_update(to_jax(grads_like(rng, params, 0.7)), js, jp)
    tp, ts = to_torch(to_numpy(jp)), convert.opt_state_from_numpy(to_numpy(js), "cpu")
    assert_same_state(ts, js)
    assert tp["layers"][1] is None and tree_leaves(ts["step"])[0].dtype == torch.int32
    # global norms above and below grad_clip
    for norm in (3.0, 0.5, 10.0, 0.9, 1.5):
        g = grads_like(rng, params, norm)
        jp, js = j_update(to_jax(g), js, jp)
        tp, ts = t_update(to_torch(g), ts, tp)
        assert_same_state(tp, jp)
        assert_same_state(ts, js)
    assert int(ts["step"]) == start + 5
    assert tp["layers"][1] is None


def test_init_matches_jax_layout():
    params = make_params(np.random.default_rng(1))
    for name, moments in CASES:
        cfg = dict(name=name, moment_dtype=moments)
        js = j_opt.make(j_opt.OptConfig(**cfg))[0](to_jax(params))
        ts = t_opt.make(t_opt.OptConfig(**cfg))[0](to_torch(params))
        assert sorted(ts) == sorted(js)
        assert_same_state(ts, js)
    ts = t_opt.make(t_opt.OptConfig(name="adafactor"))[0](to_torch(params))
    assert sorted(ts["v"]["layers"][0]) == ["vc", "vr"]     # (2, 3, 4): factored
    assert sorted(ts["v"]["layers"][2]) == ["v"]            # (1, 7): not factored
    assert ts["v"]["layers"][1] is None


@pytest.mark.parametrize("norm", [0.25, 4.0])
def test_clip_by_global_norm_matches_jax(norm):
    rng = np.random.default_rng(2)
    g = grads_like(rng, make_params(rng), norm)
    jg, jn = j_opt._clip_by_global_norm(to_jax(g), 1.0)
    tg, tn = t_opt.clip_by_global_norm(to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    np.testing.assert_allclose(float(tn), norm, rtol=1e-5)
    for t, j in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # a bfloat16 gradient comes back float32, as JAX promotes it
    bg, _ = t_opt.clip_by_global_norm({"x": torch.ones(3, dtype=torch.bfloat16)}, 1.0)
    assert bg["x"].dtype == torch.float32


def test_for_arch_matches_jax():
    from repro.configs import base as j_cfgs
    from repro_torch.configs import base as t_cfgs

    for arch in ("mind", "gin-tu"):
        assert t_opt.for_arch(t_cfgs.get_arch(arch), lr=0.01) == t_opt.OptConfig(
            **vars(j_opt.for_arch(j_cfgs.get_arch(arch), lr=0.01)))
    with pytest.raises(ValueError):
        t_opt.make(t_opt.OptConfig(name="lion"))


def test_tree_order_is_jax_flatten_order():
    tree = {"b": 1, "a": [2, None, {"z": 3, "c": 4}], "m": (5, 6)}
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    assert tree_unflatten(tree, [10 * x for x in tree_leaves(tree)]) == tree_map(
        lambda x: 10 * x, tree)
    assert flatten_up_to({"p": 0, "q": [0]}, {"p": {"v": 1}, "q": [{"vr": 2}]}) == [
        {"v": 1}, {"vr": 2}]
    with pytest.raises(ValueError):
        tree_unflatten(tree, [1, 2])


# ---------------------------------------------------------------------------
# the reference's own optimizer checks (tests/test_train_infra.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    init, update = t_opt.make(t_opt.OptConfig(name=name, lr=0.1, weight_decay=0.0))
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.ones((4, 8)) * 2.0}
    state = init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        g = {k: 2 * v for k, v in params.items()}
        params, state = update(g, state, params)
    assert float(loss(params)) < 0.05 * l0


def test_adamw_bf16_moments_memory():
    init, _ = t_opt.make(t_opt.OptConfig(name="adamw", moment_dtype="bfloat16"))
    state = init({"w": torch.zeros((128, 128))})
    assert state["m"]["w"].dtype == torch.bfloat16


def test_adafactor_state_is_factored():
    init, _ = t_opt.make(t_opt.OptConfig(name="adafactor"))
    state = init({"w": torch.zeros((256, 512))})
    v = state["v"]["w"]
    assert tuple(v["vr"].shape) == (256,) and tuple(v["vc"].shape) == (512,)


def test_update_leaves_the_callers_tensors_alone():
    init, update = t_opt.make(t_opt.OptConfig(name="adamw"))
    params = {"w": torch.ones(4)}
    state = init(params)
    new, new_state = update({"w": torch.ones(4)}, state, params)
    assert torch.equal(params["w"], torch.ones(4)) and int(state["step"]) == 0
    assert not new["w"].requires_grad and int(new_state["step"]) == 1
