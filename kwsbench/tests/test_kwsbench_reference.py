"""The plain reference against the port's module route on the CPU at
small widths, and its draws against their rules."""

import copy

import numpy as np
import pytest
import torch

from kwsbench import inputs
from kwsbench.drivers import common
from kwsbench.harness import HERE, load_json
from kwsbench.reference import frontend as rf
from kwsbench.reference import models as rm

SMALL = {
    "ds_tcn_hi_xiaowen": {"hidden_dim": 24, "backbone": {"num_layers": 3}},
}
TRAFFIC = {"sample_rate": 16000, "seconds_per_row": 0.5, "level": [300, 3000]}


def small_config(name: str) -> dict:
    config = copy.deepcopy(load_json(f"{HERE}/configs/{name}.json"))
    model = config["model"]
    over = SMALL[name]
    model["backbone"].update(over["backbone"])
    model["hidden_dim"] = over["hidden_dim"]
    return config


def test_philox_known_answers():
    def run(c, k):
        c = [torch.tensor([x], dtype=torch.int64) for x in c]
        return [int(v) for v in rf.philox4x32_10(*c, *k)]

    # Random123's kat_vectors for philox4x32_10
    assert run([0, 0, 0, 0], [0, 0]) == [0x6627e8d5, 0xe169c58d,
                                         0xbc57ac4c, 0x9b00dbd8]
    assert run([0xffffffff] * 4, [0xffffffff] * 2) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert run([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
               [0xa4093822, 0x299f31d0]) == [0xd16cfe09, 0x94fdcceb,
                                             0x5001e420, 0x24126ea1]


def test_philox_normal_is_normal_and_positional():
    n = rf.philox_normal(12345, 0, 40000, "cpu")
    assert abs(float(n.mean())) < 0.03 and abs(float(n.std()) - 1) < 0.03
    tail = rf.philox_normal(12345, 4000, 36000, "cpu")
    assert torch.equal(tail, n[4000:])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_features_and_draws_match_the_port(name):
    from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
    from wekws_tpu_torch.train.steps import step_generator

    dc = load_json(f"{HERE}/configs/{name}.json")["dataset_conf"]
    waves = inputs.waves(6, TRAFFIC, 3, "cpu").float()
    pipe = DeviceFeaturePipeline.from_conf(dc, training=True)
    got, _ = pipe(waves, torch.full((6,), waves.shape[1]),
                  generator=step_generator(99, 2, "cpu"))
    want = rf.Features(dc, "cpu")(waves, rf.step_generator(99, 2, "cpu"))
    # the port's three-matmul DFT against an FFT: float32 sums of 400
    # terms in another order, then a log (and MFCC's DCT over 80 bins)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(SMALL))
def test_train_steps_match_the_port(name):
    """Three float32 steps of the port's Trainer (module route) against
    the reference's, from the same weights, rows and draws."""
    from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
    from wekws_tpu_torch.train.steps import Trainer

    config = small_config(name)
    dc = config["dataset_conf"]
    pipe = DeviceFeaturePipeline.from_conf(dc, training=True)
    conf = common.model_conf(config, pipe.output_dim)
    model, weights = common.port_model(conf, 7, "cpu")
    trainer = Trainer(model, pipe, DeviceFeaturePipeline.from_conf(dc, False),
                      "max_pooling", grad_clip=5.0,
                      min_duration=config["min_duration"] // 10,
                      device="cpu")
    state = trainer.init_state()
    waves = inputs.waves(24, TRAFFIC, 8, "cpu")
    target = inputs.labels(24, 2, 8, "cpu")
    batches = [{"waves": waves[i::3], "wave_lengths": torch.full(
        (8,), waves.shape[1], dtype=torch.int32), "target": target[i::3],
        "valid": torch.ones(8)} for i in range(3)]
    torch.manual_seed(11)
    losses = []
    for batch in batches:
        state, m = trainer.train_step(state, batch, 21, 1e-3)
        losses.append(float(m["loss"]))
    tc = {"grad_clip": 5.0, "lr": 1e-3,
          "min_duration": config["min_duration"] // 10, "dropout": 0.1}
    ref = rm.train_steps(rm.Model(conf, "fp32"), rf.Features(dc, "cpu"),
                         weights, batches, 21, tc, dropout_seed=11)
    np.testing.assert_allclose(losses, ref["loss"], rtol=2e-3)
    params = dict(model.named_parameters())
    for k, v in ref["params"].items():
        moved = (v - weights[k]).abs().max()
        np.testing.assert_allclose(params[k].detach().numpy(), v.numpy(),
                                   atol=float(2.1 * 3e-3 * (moved > 0)) + 1e-6)
