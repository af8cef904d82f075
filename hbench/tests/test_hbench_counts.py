"""The frozen operation count against the program's own
CompiledGraph.cost_analysis()["flops"], on every configuration at small
image sizes; the byte count from the semantics alone."""

from __future__ import annotations

import pytest
import torch

from hbench import counts, harness, spec
from hbench.tests.small import SEED, small_cell


@pytest.mark.parametrize("name", ["mnv1-u8-b128", "yolov5s-i8-b8", "resnet50-i8kl-b128"])
def test_ops_equal_cost_analysis(name):
    from tengine_tpu_torch.executor.engine import compile_graph
    from tengine_tpu_torch.utils.config import Options

    cell = small_cell(name)
    pr = harness.prepare(cell, SEED, torch.device("cpu"))
    cg = compile_graph(pr.qg, Options(quant_mode="fast", batch_size=1), device="cpu")
    c = counts.count(pr.ref_mod, cell.config)
    # cost_analysis counts a conv's third input as a bias; where the program
    # fused a residual addend there instead (a split conv's partial sum),
    # that is no bias, and the frozen count leaves it out
    g = cg.graph
    addend = sum(int(torch.tensor(g.tensors[n.outputs[0]].shape).prod()) for n in g.nodes
                 if n.op == "Convolution" and n.params.get("fused_add_pos") == 2)
    assert c.ops_per_image == int(cg.cost_analysis()["flops"]) - addend


def test_bytes_of_mobilenet_by_hand():
    cfg = small_cell("mnv1-u8-b128").config
    ref, _ = spec.arch_modules(cfg["arch"])
    c = counts.count(ref, cfg)
    img = cfg["img"]
    acts = 3 * img * img  # the input, read once
    h, outs = img // 2, []
    outs.append(cfg["widths"][0] * h * h)
    for i, s in enumerate(cfg["strides"]):
        h = (h + 2 - 3) // s + 1
        outs += [cfg["widths"][i] * h * h, cfg["widths"][i + 1] * h * h]
    outs.append(cfg["widths"][-1])  # the pool
    acts += 2 * sum(outs) + cfg["classes"]  # the logits written once
    assert c.bytes_per_image == acts
    params = sum(int(torch.tensor(shape).prod()) * (4 if name.endswith(".b") else 1)
                 for name, shape, *_ in ref.params(cfg))
    assert c.param_bytes == params
