"""The frozen counts against the program's own arithmetic and the bounds
the port's records hold, and the configurations against the port's; the
same for a card's share of an expert-parallel layer (``conftest.py``)."""
from __future__ import annotations

import dataclasses

import pytest

from bench import registry
from bench.counts import flops
from bench.trace import kernel_class, short_name

CONFIGS = {c["name"]: c for c in registry.benchmark()["configs"]}


def _port_config(name: str):
    """The benchmark's configuration file and the port's configuration of
    the same model at ``tp`` 1 and the file's depth."""
    from repro_torch.configs import get_config

    cfg = registry.config(name)
    arch = cfg["arch"]
    return cfg, dataclasses.replace(get_config(arch["name"]), tp=1, n_layers=arch["n_layers"])


@pytest.mark.parametrize("name, n", [("mamba2-370m", 367_632_384),
                                     ("olmoe-1b-7b-l4", 371_982_336)])
def test_frozen_n_is_the_active_parameters_less_the_embedding(name, n):
    cfg, port = _port_config(name)
    assert flops.matmul_params(cfg["arch"]) == n
    assert n == port.active_param_count() - port.vocab * port.d_model


#: what a configuration's ``reduced`` may list: cuts of scale, never a width
SCALE_KEYS = {"batch", "n_layers", "moe_experts_held"}


def contract_faults(arch: dict, reduced, published) -> list[str]:
    """Where a configuration file's ``arch`` departs from the port's
    published configuration ``published`` (an ``ArchConfig``) as the file
    cuts it: at ``tp`` 1, with each field that ``reduced`` lists taken from
    the file.  A field the file leaves out takes its default, which the
    published configuration must then hold too; ``reduced`` lists only cuts
    of scale (:data:`SCALE_KEYS`), each differing from the published value
    (so ``n_layers`` is listed exactly when the depth was cut)."""
    cls = type(published)
    fields = {f.name for f in dataclasses.fields(cls)}
    faults = [f"reduced lists {k!r}, not a cut of scale" for k in sorted(set(reduced) - SCALE_KEYS)]
    try:
        have = cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})
    except TypeError as e:
        return faults + [f"the file's arch is no {cls.__name__}: {e}"]
    cut = {k: getattr(have, k) for k in reduced if k in fields}
    want = dataclasses.replace(published, **{"tp": 1, **cut})
    for k in sorted(fields):
        if getattr(have, k) != getattr(want, k):
            how = "the file's" if k in arch else "left out, so its default"
            faults.append(f"{k}: {how} {getattr(have, k)!r}, the port's {getattr(want, k)!r}")
    return faults + [f"reduced lists {k!r}, which the file holds at the published {v!r}"
                     for k, v in cut.items() if getattr(published, k) == v]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_configuration_is_the_port_s_but_for_what_it_lists(name):
    from repro_torch.configs import get_config

    arch = registry.config(name)["arch"]
    assert contract_faults(arch, CONFIGS[name]["reduced"], get_config(arch["name"])) == []


def _share_cls():
    """The port's ``ArchConfig`` with the share's two fields added, as a
    later program change adds them."""
    from repro_torch.models.config import ArchConfig

    return dataclasses.make_dataclass("ShareArchConfig", [("moe_experts_held", int, 0),
                                                          ("moe_shared_d_ff", int, 0)],
                                      bases=(ArchConfig,), frozen=True)


def _share_port(toy_arch: dict):
    """The toy configuration as the port would publish it: the whole depth,
    every expert held, the port's default ``tp``."""
    published = {k: tuple(v) if isinstance(v, list) else v for k, v in toy_arch.items()
                 if k != "tp"}
    return _share_cls()(**dict(published, n_layers=4, moe_experts_held=0))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_field_the_port_adds_later_leaves_a_configuration_as_it_was(name):
    """A file written before the port gained the share's two fields holds
    neither: against the port with them, at their defaults, it is still
    the port's but for what it lists."""
    from repro_torch.configs import get_config

    arch = registry.config(name)["arch"]
    published = get_config(arch["name"])
    later = _share_cls()(**dataclasses.asdict(published))
    assert contract_faults(arch, CONFIGS[name]["reduced"], later) == []
    assert contract_faults(arch, CONFIGS[name]["reduced"],
                           dataclasses.replace(later, moe_shared_d_ff=64)) == \
        ["moe_shared_d_ff: left out, so its default 0, the port's 64"]


@pytest.mark.parametrize("edit, reduced, fault", [
    (None, None, None),
    ("enc_layers", None, None),
    ("moe_shared_d_ff", None, "moe_shared_d_ff: left out, so its default 0, the port's 48"),
    ("ssm_state", None, "ssm_state: left out, so its default 0, the port's 16"),
    (("n_layers", 4), None, "reduced lists 'n_layers', which the file holds at the published 4"),
    (("moe_d_ff", 16), ["batch", "n_layers", "moe_experts_held", "moe_d_ff"],
     "reduced lists 'moe_d_ff', not a cut of scale"),
    (None, ["batch", "n_layers"], "moe_experts_held: the file's 4, the port's 0"),
    (("moe_top_k", 1), None, "moe_top_k: the file's 1, the port's 2"),
])
def test_the_contract_takes_a_share_written_under_tmp_path(share_config, edit, reduced, fault):
    """The toy share as written (``moe_experts_held`` in ``reduced``) passes,
    and so it does with a key at its default left out; a left-out key whose
    port value is not its default, a listed cut that cuts nothing, a width
    in ``reduced``, an unlisted cut and a changed key each fail, by name."""
    arch = dict(share_config["arch"])
    if isinstance(edit, str):
        del arch[edit]
    elif edit:
        arch[edit[0]] = edit[1]
    found = contract_faults(arch, reduced or list(share_config["reduced"]),
                            _share_port(share_config["arch"]))
    assert found == ([fault] if fault else []), found


def test_a_share_s_products_are_counted_by_hand(toy_arch):
    """Per period of the toy share: the Mamba layer's projections, the
    attention layer's, and at each of its two MoE positions the router over
    all 16 experts, top-2 × 4 held / 16 experts' products and the shared
    expert's; the tied head once."""
    d, v = 64, 512
    mamba = 2 * d * 128 + 2 * d * 16 + d * 8 + 128 * d  # w_x, w_z; w_B, w_C; w_dt; w_out
    attn = 2 * d * 4 * 16 + 2 * d * 2 * 16  # wq, wo; wk, wv
    moe = d * 16 + 2 * 4 * 3 * d * 32 // 16 + 3 * d * 48  # router; routed share; shared expert
    assert flops.matmul_params(toy_arch) == v * d + mamba + attn + 2 * moe == 98_816
    granite_like = dict(toy_arch, moe_top_k=10, moe_experts=72, moe_experts_held=9)
    assert flops.matmul_params(granite_like) - flops.matmul_params(
        dict(granite_like, moe_experts_held=0)) == 2 * (1.25 - 10) * 3 * d * 32


def test_ssd_counts_reproduce_the_recorded_bounds():
    scan = flops.bound_s(*flops.ssd_scan_counts(1, 1024, 32, 64, 128, 128, 2, states=False), 2)
    bwd = flops.bound_s(*flops.ssd_scan_bwd_counts(8, 4096, 32, 64, 128, 128, 2), 2)
    assert round(scan * 1e3, 6) == 0.003013
    assert round(bwd * 1e3, 6) == 0.212845


def test_model_flops_per_step():
    m = registry.config("mamba2-370m")
    ssd = flops.ssd_scan_counts(8, 4096, 32, 64, 128, 128, 2, states=True)[0]
    assert flops.model_flops_per_step(m["arch"], 8, 4096) == \
        6 * 367_632_384 * 32768 + 3 * 48 * ssd
    o = registry.config("olmoe-1b-7b-l4")
    assert flops.model_flops_per_step(o["arch"], 4, 4096) == \
        6 * 371_982_336 * 16384 + 12 * 4 * 16 * 128 * 4096 * 16384


@pytest.mark.parametrize("name, cls", [
    ("ssd_scan_mma_kernel(__nv_bfloat16 const*, float const*)", "port"),
    ("(anonymous namespace)::pass_kernel(float const*, int, float*, int, int, int)", "port"),
    ("void (anonymous namespace)::head_mma(__nv_bfloat16 const*)", "port"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float>>(int)",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(float)", "elementwise"),
    ("void at_cuda_detail::cub::DeviceScanKernel<int>(int)", "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_the_kernel_table_classes_names(name, cls):
    assert kernel_class(name) == cls


def test_short_names_drop_templates_and_arguments():
    assert short_name("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)") \
        == "at::native::reduce_kernel"
    assert short_name("(anonymous namespace)::pass_kernel(float const*)") == "pass_kernel"
