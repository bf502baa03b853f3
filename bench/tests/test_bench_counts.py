"""The frozen counts against the program's own arithmetic and the bounds
the port's records hold, and the configurations against the port's."""
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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_configuration_is_the_port_s_but_for_what_it_lists(name):
    cfg, port = _port_config(name)
    want = {k: list(v) if isinstance(v, tuple) else v for k, v in
            dataclasses.asdict(port).items()}
    assert cfg["arch"] == want
    from repro_torch.configs import get_config

    reduced = set(CONFIGS[name]["reduced"])
    assert reduced <= {"batch", "n_layers"}
    assert ("n_layers" in reduced) == (port.n_layers != get_config(port.name).n_layers)


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
