"""The seed's inputs repeat, and differ across seeds."""
import numpy as np
import pytest

from benchmark.core import traffic as tf
from benchmark.reference import netlist

BIG = 2 ** 31 + 7919


@pytest.mark.parametrize("config", ["dff_gf180", "vacask_graetz"])
def test_job_netlist_repeats_and_differs(config):
    cfg = tf.load_json("configs", config)
    a = tf.job_netlist(cfg, BIG, 3)
    assert a == tf.job_netlist(cfg, BIG, 3)
    assert a != tf.job_netlist(cfg, BIG, 4)
    assert a != tf.job_netlist(cfg, BIG + 1, 3)
    assert netlist.parse(a).elements


def test_sweep_table_repeats_and_differs():
    cfg = tf.load_json("configs", "dff_gf180")
    a = tf.sweep_table(cfg, BIG, 0, 4096)
    b = tf.sweep_table(cfg, BIG, 0, 4096)
    c = tf.sweep_table(cfg, BIG + 1, 0, 4096)
    assert list(a) == ["cq.c", "mno1.w", "mpo1.w"]
    for k in a:
        assert np.array_equal(a[k], b[k]) and not np.array_equal(a[k], c[k])
        nom = cfg["draws"][k]["nominal"]
        assert abs(a[k].mean() / nom - 1) < 0.01
        assert abs(a[k].std() / nom - 0.1) < 0.01
        assert (a[k] > 0).all()


def test_values_are_written_exactly():
    cfg = tf.load_json("configs", "vacask_graetz")
    d = tf.draw(cfg, tf.rng(BIG, 0))
    net = netlist.parse(tf.render(cfg, d))
    rl = next(e for e in net.elements if e.name == "rl")
    cl = next(e for e in net.elements if e.name == "cl")
    assert rl.params["r"] == d["rl.r"] and cl.params["c"] == d["cl.c"]


def test_job_values_are_the_seeds_draws():
    """Job k's netlist holds draw k of its own seed: fresh values in
    every job of every seed, each within a few spreads of its nominal."""
    cfg = tf.load_json("configs", "dff_gf180")
    texts = [tf.job_netlist(cfg, BIG, k) for k in range(16)]
    assert len(set(texts)) == 16
    for k, text in enumerate(texts):
        d = tf.draw(cfg, tf.rng(BIG, k))
        assert text == tf.render(cfg, d)
        for name, v in d.items():
            nom = cfg["draws"][name]["nominal"]
            assert abs(v / nom - 1) < 6 * cfg["draws"][name]["sigma_rel"]


def test_pool_gives_every_seed_the_same_draws():
    """With a pool, every seed runs the pool's draws, each once a cycle,
    in an order of its own."""
    cfg = tf.load_json("configs", "dff_gf180")
    pool = tf.load_json("traffic", "seeded_pool8_k2")["params"]["pool"]
    size = pool["size"]
    members = {tf.render(cfg, tf.draw(cfg, tf.rng(pool["seed"], i)))
               for i in range(size)}
    runs = [[tf.job_netlist(cfg, s, k, pool) for k in range(2 * size)]
            for s in (BIG, BIG + 1)]
    for texts in runs:
        assert set(texts[:size]) == members
        assert texts[size:] == texts[:size]
    assert runs[0] != runs[1]
    assert runs[0] == [tf.job_netlist(cfg, BIG, k, pool)
                       for k in range(2 * size)]
