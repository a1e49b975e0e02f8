"""The seed sets the capture's content and none of its work: the work
signature is the same for every seed, in every cell and in a whole run."""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from sdrbench import capture, manifest
from sdrbench.reference import rds as rds_ref
from sdrbench.tests.conftest import REPO, run_tiny

SEEDS = (1, 2**31 + 11, 987_654_321)


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load(REPO)["workloads"]])
def test_signature_is_the_same_for_every_seed(name):
    cell = manifest.cell(name, REPO)
    plans = [capture.plan(cell.config, cell.traffic, s) for s in SEEDS]
    sigs = [capture.signature(p) for p in plans]
    assert sigs[0] == sigs[1] == sigs[2]
    assert sigs[0]["stations"] == len(cell.config["channels"])
    # ... while the content differs
    assert len({p.stations[0].carrier_phase for p in plans}) == len(SEEDS)
    assert len({p.stations[0].tones for p in plans}) == len(SEEDS)
    if cell.traffic["rds"]:
        assert sigs[0]["rds_groups_per_s_per_station"] == pytest.approx(
            1187.5 / 104)
        assert len({p.stations[0].groups for p in plans}) == len(SEEDS)


def test_the_ring_is_seamless_and_its_rds_repeats(tiny_root):
    cell = manifest.cell("tiny.rds", tiny_root)
    p = replace(capture.plan(cell.config, cell.traffic, 5), noise_std=0.0)
    ring = capture.synthesize(p, "cpu").numpy()
    assert ring.size == p.ring_reads * p.read_bytes
    # the same stations over a ring twice as long (each tone twice the
    # cycles) give the ring twice, byte for byte: nothing jumps at the wrap
    twice = replace(p, ring_reads=2 * p.ring_reads, stations=tuple(
        replace(st, tones=tuple((2 * c, a, t) for c, a, t in st.tones))
        for st in p.stations))
    assert np.array_equal(capture.synthesize(twice, "cpu").numpy(),
                          np.concatenate([ring, ring]))
    for st in p.stations:
        bits = np.concatenate([capture.group_bits(g) for g in st.groups])
        assert bits.sum() % 2 == 0 and len(set(st.groups)) == len(st.groups)


def test_a_whole_run_prints_the_same_signature_for_two_seeds(tiny_root):
    sigs = []
    for seed in (3, 2**31 + 3):
        _, log = run_tiny(tiny_root, seed=seed, seconds=0.3)
        line = [ln for ln in log.splitlines() if ln.startswith("work signature: ")]
        sigs.append(json.loads(line[0].split(": ", 1)[1]))
    assert sigs[0] == sigs[1]
    assert sigs[0]["graph_keys"] == {"WidebandStreamer": 1, "RdsReceiver": 2}


def test_the_same_seed_gives_the_same_bytes(tiny_root):
    cell = manifest.cell("tiny.rds", tiny_root)
    a, b = (capture.synthesize(capture.plan(cell.config, cell.traffic, 77), "cpu")
            for _ in range(2))
    assert torch.equal(a, b)


def test_rds_comparison_counts_wrong_and_missed_groups():
    ring = [(1, k, 0, 0) for k in range(10)]
    whole = 40                                   # groups whole in the fed bits
    sound = [ring[k % 10] for k in range(3, whole - 2)]
    r = rds_ref.compare([ring], [sound], whole * 104)
    assert r == {"wrong": 0, "missed": 0, "expected": whole - 5}
    gap = sound[:10] + sound[12:]
    assert rds_ref.compare([ring], [gap], whole * 104)["missed"] == 2
    bad = sound[:5] + [(1, 99, 0, 0)] + sound[5:]
    assert rds_ref.compare([ring], [bad], whole * 104)["wrong"] == 1
    assert rds_ref.compare([ring], [sound[:20]], whole * 104)["missed"] == 15
    assert rds_ref.compare([ring], [[]], whole * 104)["missed"] == whole - 5
