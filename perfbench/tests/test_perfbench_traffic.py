"""The frozen traffic: YCSB's key chooser (its Zipfian, its hash, its
redraw), the hottest key's share, each mix's exact shares, and seed 0's
batches against the hashes kept beside the traffic files."""

import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest

from perfbench.lib import harness
from perfbench.lib.zipf import (ITEM_COUNT, ZETAN, KeyChooser, Zipfian,
                                fnvhash64, scramble, zeta)

HASHES = Path(harness.ROOT) / "perfbench" / "traffic" / "seed0.sha256.json"


def java_fnvhash64(val: int) -> int:
    """YCSB's Utils.fnvhash64 with Java's 64-bit long arithmetic."""
    mask = (1 << 64) - 1
    h = 0xCBF29CE484222325
    v = val & mask
    for _ in range(8):
        h = ((h ^ (v & 0xFF)) * 1099511628211) & mask
        v >>= 8                  # val >> 8 on a non-negative long
    s = h - (1 << 64) if h >> 63 else h
    return abs(s) if s != -(1 << 63) else s


def java_next_long(u: float, items: int, theta: float, zetan: float) -> int:
    """YCSB's ZipfianGenerator.nextLong for one draw ``u``, in Python's
    floats (Java's doubles)."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + math.pow(2.0, -theta)
    eta = (1 - math.pow(2.0 / items, 1 - theta)) / (1 - zeta2 / zetan)
    uz = u * zetan
    if uz < 1.0:
        return 0
    if uz < 1.0 + math.pow(0.5, theta):
        return 1
    return int(items * math.pow(eta * u - eta + 1, alpha))


def test_scramble_is_ycsbs_fnv_hash_modulo_the_key_count():
    vals = [0, 1, 2, 11, 255, 256, 65535, (1 << 24) - 1, (1 << 40) + 5,
            (1 << 62) + 3, ITEM_COUNT]
    assert fnvhash64(vals).tolist() == [java_fnvhash64(v) for v in vals]
    n = (1 << 24) + 1
    keys = scramble(np.arange(100_000), n)
    assert keys.min() >= 0 and keys.max() < n
    assert keys.tolist()[:4] == [java_fnvhash64(v) % n for v in range(4)]


def test_ranks_follow_ycsbs_closed_form_over_ten_billion_items():
    us = [0.0, 0.01, 0.0377, 0.0378, 0.05, 0.057, 0.1, 0.3, 0.5, 0.9,
          0.999, 0.999999]
    z = Zipfian(ITEM_COUNT + 1, 0.99, ZETAN)
    assert z.ranks(us).tolist() == [
        java_next_long(u, ITEM_COUNT + 1, 0.99, ZETAN) for u in us]
    assert z.ranks(us).max() > 1 << 32        # far past the key count


def test_the_precomputed_zetan_is_the_sum_it_stands_for():
    # the sum's tail past 2^24 by its integral, as a check of ZETAN
    n, theta = 1 << 24, 0.99
    tail = ((ITEM_COUNT + 0.5) ** (1 - theta)
            - (n + 0.5) ** (1 - theta)) / (1 - theta)
    assert abs(zeta(n, theta) + tail - ZETAN) < 1e-6


@pytest.mark.parametrize("n", [1 << 12, 1 << 24])
def test_keys_lie_in_the_key_space_and_the_last_slot_is_drawn_again(n):
    chooser = KeyChooser(n, 0.99)
    keys = chooser.keys(np.random.default_rng(5), 1 << 16)
    assert keys.min() >= 0 and keys.max() < n


def test_a_hash_past_the_last_key_is_drawn_again():
    # one key: every rank whose hash is odd lands past it and is redrawn
    rng = np.random.default_rng(6)
    assert not KeyChooser(1, 0.99).keys(rng, 4096).any()
    ranks = Zipfian(ITEM_COUNT + 1, 0.99, ZETAN).ranks(
        np.random.default_rng(6).random(4096))
    assert (fnvhash64(ranks) % 2).any()


def test_the_hottest_ranks_land_on_distinct_leaves():
    # a leaf holds at most 12 consecutive keys: keys 12 apart or more
    # lie in different leaves
    keys = np.sort(scramble(np.arange(32), (1 << 24) + 1))
    assert np.diff(keys).min() >= 12


def test_the_hottest_key_takes_one_over_zetan_of_the_draws():
    n, draws = 1 << 24, 1 << 20
    keys = KeyChooser(n, 0.99).keys(np.random.default_rng(1), draws)
    share = float(np.mean(keys == java_fnvhash64(0) % (n + 1)))
    p = 1 / ZETAN
    sd = math.sqrt(p * (1 - p) / draws)
    assert abs(share - p) < 5 * sd
    assert np.bincount(keys).argmax() == java_fnvhash64(0) % (n + 1)


def test_unscrambled_ranks_are_keys_with_one_over_h_on_key_zero():
    n, draws = 1 << 16, 1 << 20
    h = zeta(n, 0.99)
    keys = KeyChooser(n, 0.99, scrambled=False).keys(
        np.random.default_rng(2), draws)
    sd = math.sqrt((1 / h) * (1 - 1 / h) / draws)
    assert keys.max() < n
    assert abs(float(np.mean(keys == 0)) - 1 / h) < 5 * sd


def _traffic(name, seed=0):
    cell = harness.Cell(name)
    return cell.generator.Traffic(cell.config, cell.traffic, seed)


@pytest.mark.parametrize("name,reads", [("btree.ycsb-c", 1024),
                                        ("btree.ycsb-a", 512)])
def test_each_ycsb_batch_holds_its_shares_exactly(name, reads):
    gen = _traffic(name, seed=2**31 + 3)
    for i in range(6):
        b = gen.batch(i)
        assert int(b["is_read"].sum()) == reads
        assert b["node"] == i % 4
        assert b["keys"].min() >= 0 and b["keys"].max() < 1 << 24


def digest(name) -> str:
    gen = _traffic(name, seed=0)
    h = hashlib.sha256()
    for i in range(4):
        b = gen.batch(i)
        for k in ("keys", "is_read", "vals"):
            h.update(np.ascontiguousarray(b[k]).tobytes())
        h.update(str(b["node"]).encode())
    return h.hexdigest()


def test_seed_zero_batches_match_the_hashes_kept_beside_them():
    want = json.loads(HASHES.read_text())
    assert {t: digest(f"btree.{t}") for t in ("ycsb-c", "ycsb-a")} == want
