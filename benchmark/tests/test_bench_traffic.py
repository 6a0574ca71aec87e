"""The inputs made from a seed: the same seed gives the same, another seed
another order of the same work."""

import json
import os

import numpy as np

from benchmark import data, harness


def traffic(workload):
    return harness.cell_files(workload)["traffic"]


def test_requests_repeat_for_a_seed_and_differ_across_seeds():
    t = traffic("serve-int8-1to3")
    a, b = data.requests(2**40 + 3, t), data.requests(2**40 + 3, t)
    c = data.requests(2**40 + 4, t)
    assert a == b and a != c
    # every pool image once, and the same (size, prompt count) pairs in each
    # seed: each size with the prompt counts in the traffic's shares
    work = []
    for seed, reqs in ((2**40 + 3, a), (2**40 + 4, c)):
        assert sorted(i for i, _ in reqs) == list(range(t["pool"]))
        plan = data._plan(seed, t["pool"], t["sizes"], t["instances"])
        work.append(sorted((plan[i][0], len(p)) for i, p in reqs))
    assert work[0] == work[1]
    per_size = sorted(n for size, n in work[0] if size == tuple(t["sizes"][0]))
    assert per_size == [1] * 5 + [2] * 3 + [3] * 2
    # at a pool that no block divides, the shares as near as it allows
    small = data.requests(5, dict(t, pool=6, sizes=[[64, 48], [40, 72]]))
    assert sorted(len(p) for _, p in small) == [1, 1, 1, 1, 2, 2]


def test_sessions_and_check_sample_are_seeded():
    t = traffic("prompts-bf16-8")
    a = data.sessions(7, t, 30)
    assert a == data.sessions(7, t, 30) and a != data.sessions(8, t, 30)
    assert all(len(p) == t["prompts_per_session"] for _, p in a)
    s = data.check_sample(7, a, 2, 12)
    assert s == data.check_sample(7, a, 2, 12) and len(s) == 2


def test_images_and_dataset_are_seeded(tmp_path):
    t = dict(traffic("train-int8-b8"), images=4, sizes=[[64, 48], [40, 72]])
    roots = [data.write_coco(str(tmp_path / n), s, t) for n, s in (("a", 5), ("b", 5), ("c", 6))]
    anns = [json.load(open(os.path.join(r, "train", "_annotations.coco.json"))) for r in roots]
    assert anns[0] == anns[1] and anns[0] != anns[2]
    sizes = sorted((im["width"], im["height"]) for im in anns[2]["images"])
    assert sizes == [(40, 72), (40, 72), (64, 48), (64, 48)]  # equal shares for every seed
    img1, _ = data.draw_image(5, 0, (64, 48), 3, t["categories"])
    img2, _ = data.draw_image(5, 0, (64, 48), 3, t["categories"])
    assert img1.shape == (48, 64, 3) and np.array_equal(img1, img2)


def test_large_seeds_are_taken():
    t = traffic("serve-int8-1to3")
    assert data.requests(2**70 + 1, t) != data.requests(2**70 + 2, t)
