"""The general union form: a chain union written as per-join node lists is
built, judged and counted exactly as the chain form and as recorded before
the form was general; a chain reference refuses other shapes by name; and
faults on a branching and a cyclic union are caught."""

import dataclasses
import json

import numpy as np
import pytest

from unionbench import inputs, program, roofline
from unionbench.inputs import Node
from unionbench.reference import chain_union
from unionbench.reference.judge import judge
from unionbench.tests import shapes, support

NAMES = ["request_size_errors", "rows_not_in_home", "rows_in_earlier_piece",
         "home_z", "law_z", "union_law_z", "dup_z"]
BATCHES = {"uq1": [4096, 2048, 1024, 512, 256], "uq2": [8192, 3000, 0]}
# judge numbers (float.hex), where law_z and union_law_z peak, and the
# roofline's round bytes, probe bytes and probe launches, recorded from the
# chain-only harness on the rows of _judged below
FROZEN = {
    "uq1": ({"request_size_errors": "0x1.0000000000000p+0",
             "rows_not_in_home": "0x1.8000000000000p+2",
             "rows_in_earlier_piece": "0x1.0000000000000p+0",
             "home_z": "0x1.298dc0b1d56c1p+0",
             "law_z": "0x1.38e9c8f66c9e0p+0",
             "union_law_z": "-0x1.710f3a04319ccp-1",
             "dup_z": "-0x1.cd9816aab87c5p-4"},
            [(4, "lineitem"), "orders"], 1947648.0, 426624.0, 20),
    "uq2": ({"request_size_errors": "0x1.0000000000000p+0",
             "rows_not_in_home": "0x1.0000000000000p+0",
             "rows_in_earlier_piece": "0x1.8000000000000p+2",
             "home_z": "0x1.0000000000000p+1",
             "law_z": "0x1.fd0052a515dc2p+0",
             "union_law_z": "0x1.9b89c3a627fc1p+0",
             "dup_z": "-0x1.b226b29f44c92p-3"},
            [(0, "nation"), "nation"], 1928256.0, 554496.0, 8),
}
CONFIGS = {"uq1": "uq1-sf1", "uq2": "uq2-sf1"}


def _union(builder, general=False):
    cfg = json.loads((support.PKG / "configs" / f"{CONFIGS[builder]}.json")
                     .read_text())
    cfg.update(support.SCALES[builder])
    union = inputs.build(cfg, support.SEED)
    if general:
        # every join with its own node list, each parent named
        nodes = [Node(n.relation, n.edge, union.chain[i - 1].relation if i else None)
                 for i, n in enumerate(union.chain)]
        union = dataclasses.replace(union, chain=[], joins=[
            dataclasses.replace(j, nodes=list(nodes)) for j in union.joins])
    return union


def _judged(union):
    """Rows the reference samples, seven of them credited to the next
    piece, and two requests, one of them short."""
    ref = chain_union.reference(union)
    ids, home = ref.sample(30_000, np.random.default_rng(5))
    home = home.copy()
    home[:7] = (home[:7] + 1) % len(union.joins)
    return judge(ref, [len(home), 3], [len(home), 2], ref.rows_of(ids), home,
                 NAMES)


@pytest.mark.parametrize("general", [False, True], ids=["chain", "general"])
@pytest.mark.parametrize("builder", ["uq1", "uq2"])
def test_numbers_match_the_chain_only_harness(builder, general):
    union = _union(builder, general)
    assert (union.joins[0].nodes is not None) == general
    numbers, info = _judged(union)
    frozen, at, rb, pb, launches = FROZEN[builder]
    assert {k: float(v).hex() for k, v in numbers.items()} == frozen
    assert [tuple(info["law_z_at"]), info["union_law_z_at"]] == at
    b = BATCHES[builder]
    assert roofline.round_bytes(union, b) == rb
    assert roofline.probe_bytes(union, b) == pb
    assert roofline.probe_launches_per_round(union, b) == launches


@pytest.mark.parametrize("builder", ["uq1", "uq2"])
def test_general_form_builds_the_same_program_joins(builder):
    """Chains written as node lists are built by ``chain_join`` as before:
    the same joins, sizes and shared pushdown bases."""
    from repro_torch.core.joins import join_size
    built = []
    for general in (False, True):
        cat, joins = program.specs(_union(builder, general))
        built.append((cat, joins))
    (cat0, chain), (cat1, general) = built
    for a, b in zip(chain, general):
        assert a.is_chain and b.is_chain
        assert [(n.alias, n.parent, n.edge_attrs) for n in a.nodes] == \
               [(n.alias, n.parent, n.edge_attrs) for n in b.nodes]
        assert join_size(cat0, a) == join_size(cat1, b) > 0
    shared = [[j.pushdown_base is joins[0].pushdown_base for j in joins]
              for joins in (chain, general)]
    assert shared[0] == shared[1]


def _shape(name, **kw):
    cfg = {"shape": name, "sf": 0.002, "overlap": 0.4,
           "joins": [{"name": "Q5_J0"}, {"name": "Q5_J1"}]}
    cfg.update(kw)
    return shapes.build(cfg, support.SEED)


@pytest.mark.parametrize("shape,words", [("branching", "branching tree"),
                                         ("cyclic", "is cyclic")])
def test_chain_reference_names_the_shape_it_refuses(shape, words):
    with pytest.raises(ValueError, match=words):
        chain_union.reference(_shape(shape))


def _first_join(ref, union):
    """The values of every tuple of the first join (its piece)."""
    rows = {}
    for p, rel in enumerate(ref.nodes(0)):
        for a, c in union.relations[rel].items():
            rows.setdefault(a, c[ref.ids[0][:, p]])
    return rows


@pytest.mark.parametrize("shape", ["branching", "cyclic"])
def test_rows_credited_to_a_later_piece_are_caught(shape):
    union = _shape(shape)
    ref = shapes.reference(union)
    rows = _first_join(ref, union)
    home = np.zeros(len(rows["ck"]), np.int64)
    clean, _ = judge(ref, [1], [1], rows, home, NAMES[:3])
    assert clean == dict.fromkeys(NAMES[:3], 0)
    also = np.flatnonzero(ref.member(rows, 1))[:5]
    assert also.size == 5
    home[also] = 1
    got, _ = judge(ref, [1], [1], rows, home, NAMES[:3])
    assert got["rows_in_earlier_piece"] == 5 and got["rows_not_in_home"] == 0


def test_a_row_that_breaks_the_residual_edge_is_caught():
    """Tuples of the skeleton (every base row kept by the join) whose
    supplier's nation is not the customer's."""
    union = _shape("cyclic")
    ref = shapes.reference(union)
    skeleton = dataclasses.replace(union, joins=[dataclasses.replace(
        j, nodes=[n for n in union.nodes(k) if n.kind == "tree"])
        for k, j in enumerate(union.joins)])
    rows = _first_join(shapes.reference(skeleton), skeleton)
    broken = np.flatnonzero(rows["s_nationkey"] != rows["nk"])[:4]
    closed = np.flatnonzero(rows["s_nationkey"] == rows["nk"])
    assert broken.size == 4 and closed.size > 0
    pick = {a: c[np.concatenate([closed, broken])] for a, c in rows.items()}
    home = np.zeros(closed.size + 4, np.int64)
    got, _ = judge(ref, [1], [1], pick, home, NAMES[:3])
    assert got["rows_not_in_home"] == 4
