"""The plain reference against the port at a small width on the CPU: one
seeded train step's losses, gradients and updates, and one sampled batch,
from the same weights and inputs, in f32."""

import torch

from benchmark import cells, check, program, traffic
from benchmark.kinds import sample, train
from benchmark.reference import step as ref
from benchmark.tests.small import small_cell

SEED = 2**31 + 101
CPU = torch.device("cpu")


def test_three_train_steps_match_the_port():
    cell = small_cell("coco128.train_b256")
    side, _, _ = train.program_train(cell, SEED, CPU)
    want = train.reference_train(cell, SEED, CPU)
    numbers = check.train_numbers(side, want)
    gaps = [abs(a - b) for sa, sb in zip(side["losses"], want["losses"]) for a, b in zip(sa, sb)]
    assert max(gaps) < 1e-4, (side["losses"], want["losses"])
    assert numbers["grad_gap"] < 1e-4, numbers
    # Adam moves a parameter with a near-zero gradient by the sign of its round-off
    assert numbers["update_gap"] < 1e-2, numbers
    assert len(want["losses"]) == 3 and sum(g > 0 for g in want["grad"].values()) > 0.9 * len(want["grad"])


def test_a_sampled_batch_matches_the_port():
    cell = small_cell("coco128.sample_b128")
    prog = program.build_sampler(cell.config,
                                 cells.draw_weights(cell.config, SEED, CPU, parts=("G",)), CPU)
    lay = traffic.pool(SEED, cell.config, cell.traffic, CPU, images=False)[3]
    rng = torch.Generator()
    traffic.seed_unit(SEED, 3, rng, CPU)
    got = ref.to_uint8(prog.sample(lay["boxes"], lay["labels"], rng))
    want = sample.reference_images(cell, SEED, CPU, [3])[3]
    assert check.image_numbers(got, want)["image_rms_mean"] < 0.05
    assert want.float().std() > 5  # images, not a flat grey


def test_the_seed_fixes_every_input():
    cell = small_cell("coco128.train_b256")
    a = traffic.pool(SEED, cell.config, cell.traffic, CPU, images=True)
    b = traffic.pool(SEED, cell.config, cell.traffic, CPU, images=True)
    c = traffic.pool(SEED + 1, cell.config, cell.traffic, CPU, images=True)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["images"], c[0]["images"])
    real = (a[0]["labels"] != 0).sum(dim=1)
    lo, hi = cell.config["objects"]
    assert int(real.min()) >= lo and int(real.max()) <= hi
    w1 = cells.draw_weights(cell.config, SEED, CPU)
    w2 = cells.draw_weights(cell.config, SEED, CPU)
    assert all(torch.equal(w1["G"][k], w2["G"][k]) for k in w1["G"])
