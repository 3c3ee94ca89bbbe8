"""The port's host-side strategy plane held against the JAX package's:
strategy trees and their round lowering, the XML artifacts, the relay role
algebra, the merged round tables and the gradient bucket plan.

All of it is pure Python on both sides, so equality is exact.  The JAX
package is imported inside the functions that use it.
"""

import pathlib

import numpy as np
import pytest
import torch

from adapcc_tpu_torch.comm import engine, relay
from adapcc_tpu_torch.ddp.bucketing import build_bucket_plan, flatten_to_buckets, unflatten_from_buckets
from adapcc_tpu_torch.ddp.trainer import DDPTrainer
from adapcc_tpu_torch.models.gpt2 import GPT2, GPT2Config
from adapcc_tpu_torch.strategy import xml_io
from adapcc_tpu_torch.strategy.ir import CommRound, Strategy, Tree

FIXTURES = sorted((pathlib.Path(__file__).parent / "fixtures" / "strategy").glob("*.xml"))


def _rounds(rounds):
    return [tuple(r.edges) for r in rounds]


def _groups(groups):
    """A merged group table as plain lists (the JAX one holds numpy rows)."""
    return [(tuple(tuple(e) for e in perm), list(map(int, src)), list(map(int, dst)), list(map(bool, is_dst)))
            for perm, src, dst, is_dst in groups]


def _plan_tables(plan):
    return None if plan is None else (_groups(plan.reduce_groups), _groups(plan.broadcast_groups))


def _assert_same_strategy(port, ref):
    assert (port.world_size, port.chunk_bytes, port.tree_chunk_bytes, port.synthesis, port.wire_dtype) == (
        ref.world_size, ref.chunk_bytes, ref.tree_chunk_bytes, ref.synthesis, ref.wire_dtype)
    assert port.tree_shares() == ref.tree_shares() and port.num_trans == ref.num_trans
    assert port.fingerprint() == ref.fingerprint()
    for t, r in zip(port.trees, ref.trees, strict=True):
        assert (t.root, t.children, t.parent, t.ips, t.ranks) == (r.root, r.children, r.parent, r.ips, r.ranks)
        assert _rounds(t.reduce_rounds()) == _rounds(r.reduce_rounds())
        assert _rounds(t.broadcast_rounds()) == _rounds(r.broadcast_rounds())


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_fixture_strategies_lower_like_jax(path):
    """Each reference strategy XML: trees, tree queries, rounds, shares,
    fingerprint and the merged group tables; then the emit → parse round
    trip, whose text is the JAX package's."""
    from adapcc_tpu.comm.engine import _merged_plan as jax_merged_plan
    from adapcc_tpu.strategy.xml_io import emit_strategy_xml as jax_emit
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jax_parse

    port, ref = xml_io.parse_strategy_xml(str(path)), jax_parse(str(path))
    _assert_same_strategy(port, ref)
    for t, r in zip(port.trees, ref.trees):
        for rank in sorted(t.ranks):
            assert (t.precedents(rank), t.subsequent(rank), t.sibling_index(rank), t.subtree(rank),
                    t.height(rank), t.depth(rank)) == (
                r.precedents(rank), r.subsequent(rank), r.sibling_index(rank), r.subtree(rank),
                r.height(rank), r.depth(rank))
            for other in sorted(t.ranks):
                assert t.is_cross_host(rank, other) == r.is_cross_host(rank, other)
    assert _plan_tables(engine._merged_plan(port)) == _plan_tables(jax_merged_plan(ref))

    text = xml_io.emit_strategy_xml(port)
    assert text == jax_emit(ref)
    _assert_same_strategy(xml_io.parse_strategy_xml(text), ref)


def test_built_strategies_and_their_attributes_round_trip_like_jax():
    """``Strategy.ring``/``binary`` with shares, per-tree chunks and a codec,
    through both packages' emitters and parsers."""
    from adapcc_tpu.comm.engine import _merged_plan as jax_merged_plan
    from adapcc_tpu.strategy.ir import Strategy as JaxStrategy
    from adapcc_tpu.strategy.xml_io import emit_strategy_xml as jax_emit
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jax_parse

    ips = {r: f"h{r // 2}" for r in range(6)}
    for build in ("ring", "binary"):
        for world, trans in ((4, 1), (4, 2), (4, 4), (6, 3)):
            port = getattr(Strategy, build)(world, trans, ips if world == 6 else None)
            ref = getattr(JaxStrategy, build)(world, trans, ips if world == 6 else None)
            _assert_same_strategy(port, ref)
            assert _plan_tables(engine._merged_plan(port)) == _plan_tables(jax_merged_plan(ref))
    trees = Strategy.ring(4, 2).trees
    port = Strategy(trees, 4, 1 << 20, shares=[3, 1], tree_chunk_bytes=[4096, 8192], synthesis="milp",
                    wire_dtype="int8")
    ref = JaxStrategy(JaxStrategy.ring(4, 2).trees, 4, 1 << 20, shares=[3, 1], tree_chunk_bytes=[4096, 8192],
                      synthesis="milp", wire_dtype="int8")
    _assert_same_strategy(port, ref)
    assert port.shares == [0.75, 0.25] and port.chunk_bytes_for_tree(1) == 8192
    text = xml_io.emit_strategy_xml(port)
    assert text == jax_emit(ref)
    _assert_same_strategy(xml_io.parse_strategy_xml(text), jax_parse(text))
    # skewed shares (max > 2 · min) leave the trees unmerged in both
    assert engine._merged_plan(port) is None and jax_merged_plan(ref) is None


def test_strategy_and_artifact_validation_raise_like_jax(tmp_path):
    trees = Strategy.ring(2, 2).trees
    for kw, match in [({"shares": [1.0]}, "one entry per tree"), ({"shares": [0, 0]}, "positive"),
                      ({"tree_chunk_bytes": [1]}, "one entry per tree"),
                      ({"tree_chunk_bytes": [1, 0]}, "must be positive"), ({"wire_dtype": "fp8"}, "codec")]:
        with pytest.raises(ValueError, match=match):
            Strategy(trees, 2, **kw)
    with pytest.raises(ValueError, match="partial permutation"):
        CommRound(((0, 1), (0, 2)))
    with pytest.raises(ValueError, match="two parents"):
        Tree(0, {0: [1], 2: [1]})
    with pytest.raises(ValueError, match="missing ranks"):
        Strategy([Tree(0, {0: [1]})], 3)
    good = '<trees><root id="0" ip="a"><gpu id="1" ip="a"/></root></trees>'
    for bad, match in [(good.replace("<trees>", '<trees schema="2.0">'), "schema major"),
                       (good.replace("<trees>", '<trees chunk_bytes="-4">'), "chunk_bytes"),
                       (good.replace('<root id="0"', '<root chunk_bytes="x" id="0"'), "chunk_bytes"),
                       (good.replace("<trees>", '<trees wire_dtype="int4">'), "wire_dtype"),
                       ("<graph/>", "expected <trees>")]:
        with pytest.raises(ValueError, match=match):
            xml_io.parse_strategy_xml(bad)
    # a two-level sketch parses now (tests/test_torch_two_level.py); a bad
    # one still fails at the file that carries it
    with pytest.raises(ValueError, match="pod_size must be >= 2"):
        xml_io.parse_strategy_xml(good.replace("<trees>", '<trees hier="2x1">'))
    with pytest.raises(ValueError, match="expected '<pods>x<pod_size>'"):
        xml_io.parse_strategy_xml(good.replace("<trees>", '<trees hier="2by1">'))
    # a newer minor of the same major is accepted; a reference file has no stamp
    assert xml_io.parse_strategy_xml(good.replace("<trees>", '<trees schema="1.7">')).world_size == 2
    # the reference's attribute pairs without a space between them
    assert xml_io.parse_strategy_xml("<trees><root id='0'ip='a'><gpu id='1'ip='a'/></root></trees>").trees[0].ips == {
        0: "a", 1: "a"}
    path = tmp_path / "s.xml"
    xml_io.emit_strategy_xml(Strategy.ring(3), str(path))
    assert xml_io.parse_strategy_xml(str(path)).fingerprint() == Strategy.ring(3).fingerprint()


def test_logical_graph_and_ip_table_match_jax(tmp_path):
    from adapcc_tpu.strategy import xml_io as jax_xml

    graph = xml_io.LogicalGraph([xml_io.ServerEntry(0, "10.0.0.1", 0, [0, 1, 2, 3]),
                                 xml_io.ServerEntry(1, "10.0.0.2", 1, [4, 5, 6, 7])], version="v1")
    ref = jax_xml.LogicalGraph([jax_xml.ServerEntry(0, "10.0.0.1", 0, [0, 1, 2, 3]),
                                jax_xml.ServerEntry(1, "10.0.0.2", 1, [4, 5, 6, 7])], version="v1")
    text = xml_io.emit_logical_graph_xml(graph, str(tmp_path / "g.xml"))
    assert text == jax_xml.emit_logical_graph_xml(ref)
    for parsed in (xml_io.parse_logical_graph_xml(text), xml_io.parse_logical_graph_xml(str(tmp_path / "g.xml"))):
        want = jax_xml.parse_logical_graph_xml(text)
        assert (parsed.rank_to_ip(), parsed.local_rank0_list(), parsed.world_size, parsed.version) == (
            want.rank_to_ip(), want.local_rank0_list(), want.world_size, want.version)
    with pytest.raises(ValueError, match="expected <graph>"):
        xml_io.parse_logical_graph_xml("<trees/>")
    xml_io.write_ip_table(["a", "b", "c"], str(tmp_path / "ips"))
    assert xml_io.read_ip_table(str(tmp_path / "ips")) == jax_xml.read_ip_table(str(tmp_path / "ips")) == ["a", "b", "c"]


@pytest.mark.parametrize("name", ["4-4_1", "8_binary", "6-6"])
def test_relay_roles_and_pruned_rounds_match_jax(name):
    """Every rank's roles and the pruned rounds of each tree, under the full
    world, one relay, a dead root, one active rank and none."""
    from adapcc_tpu.comm import relay as jax_relay
    from adapcc_tpu.strategy.xml_io import parse_strategy_xml as jax_parse

    path = str(FIXTURES[0].parent / f"{name}.xml")
    port, ref = xml_io.parse_strategy_xml(path), jax_parse(path)
    world = port.world_size
    for active in (range(world), [r for r in range(world) if r != 3], range(1, world), [world - 1], []):
        for t, r in zip(port.trees, ref.trees):
            assert relay.compute_roles(t, active) == {
                k: relay.RelayRole(*vars(v).values()) for k, v in jax_relay.compute_roles(r, active).items()}
            assert relay.live_ranks(t, frozenset(active)) == jax_relay.live_ranks(r, frozenset(active))
            for rank in sorted(t.ranks):
                assert relay.active_recvs(t, rank, frozenset(active)) == jax_relay.active_recvs(
                    r, rank, frozenset(active))
            assert _rounds(relay.prune_reduce_rounds(t, active)) == _rounds(jax_relay.prune_reduce_rounds(r, active))
            assert _rounds(relay.prune_broadcast_rounds(t, active)) == _rounds(
                jax_relay.prune_broadcast_rounds(r, active))


def _flax_leaves(model):
    """The flax tree of ``model`` as numpy (kernels transposed), and the
    port's leaves in the trainer's order and layout."""
    order, transposed = DDPTrainer._flax_layout(model)
    params = list(model.parameters())
    leaves = [params[i].detach().t() if transposed[i] else params[i].detach() for i in order]
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        key = {"bias": "bias"}.get(leaf) or ("embedding" if path[-1] in ("wte", "wpe") else
                                              "scale" if path[-1].startswith("ln") else "kernel")
        arr = p.detach().float().numpy()
        node[key] = arr.T if key == "kernel" else arr
    return tree, leaves


@pytest.mark.parametrize("cap_mb", [100.0, 0.05, 0.004])
def test_bucket_plan_of_the_small_gpt2_matches_jax(cap_mb):
    """The plan on the small GPT-2's parameters in flax order and layout:
    ``leaf_bucket``, ``bucket_sizes``, ``chunk_bytes``, ``bucket_bytes``,
    ``oversized_leaves``; the buckets' contents equal JAX's
    ``flatten_to_buckets`` and unflatten inverts it."""
    import jax
    import jax.numpy as jnp

    from adapcc_tpu.ddp.bucketing import build_bucket_plan as jax_plan
    from adapcc_tpu.ddp.bucketing import flatten_to_buckets as jax_flatten

    model = GPT2(GPT2Config(vocab_size=256, max_seq=32, n_layer=2, n_head=2, d_model=64, dtype=torch.float32),
                 device="cpu", seed=0)
    tree, leaves = _flax_leaves(model)
    want = jax_plan(tree, cap_mb)
    got = build_bucket_plan(leaves, cap_mb)
    assert got.leaf_shapes == want.leaf_shapes
    assert (got.leaf_bucket, got.bucket_sizes, got.chunk_bytes, got.bucket_bytes, got.oversized_leaves) == (
        want.leaf_bucket, want.bucket_sizes, want.chunk_bytes, want.bucket_bytes, want.oversized_leaves)
    assert got.num_buckets == want.num_buckets and got.total_bytes == want.total_bytes
    buckets = flatten_to_buckets(got, leaves)
    for b, w in zip(buckets, jax_flatten(want, jax.tree_util.tree_map(jnp.asarray, tree)), strict=True):
        assert np.array_equal(b.numpy(), np.asarray(w))
    for leaf, back in zip(leaves, unflatten_from_buckets(got, buckets), strict=True):
        assert torch.equal(leaf, back)


def test_bucket_concatenation_promotes_like_jnp():
    """A bucket of bfloat16 and float32 leaves is float32, as in
    ``jnp.concatenate``; each leaf comes back in the bucket's dtype."""
    import jax.numpy as jnp

    from adapcc_tpu.ddp.bucketing import build_bucket_plan as jax_plan
    from adapcc_tpu.ddp.bucketing import flatten_to_buckets as jax_flatten

    leaves = [torch.arange(6, dtype=torch.bfloat16).view(2, 3), torch.arange(4, dtype=torch.float32) / 3,
              torch.arange(5, dtype=torch.int32)]
    tree = {"a": jnp.asarray(leaves[0].float().numpy(), jnp.bfloat16), "b": jnp.asarray(leaves[1].numpy()),
            "c": jnp.asarray(leaves[2].numpy())}
    plan = build_bucket_plan(leaves)
    assert (plan.bucket_sizes, plan.bucket_bytes) == (jax_plan(tree).bucket_sizes, jax_plan(tree).bucket_bytes)
    [bucket] = flatten_to_buckets(plan, leaves)
    [want] = jax_flatten(jax_plan(tree), tree)
    assert str(bucket.dtype).removeprefix("torch.") == str(want.dtype) == "float32"
    assert np.array_equal(bucket.numpy(), np.asarray(want))
    assert [t.dtype for t in unflatten_from_buckets(plan, [bucket])] == [torch.float32] * 3
    with pytest.raises(ValueError, match="no gradient leaves"):
        build_bucket_plan([])
