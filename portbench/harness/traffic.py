"""The one traffic generator: seeded batches of one circuit's proofs.

A mix (``traffic/<name>.json``) gives:

- ``batch_size``: lanes a call;
- ``invalid_per_batch``: how many lanes of each distinct batch hold an
  invalid proof (its length is the number of distinct batches, which the
  closed loop cycles through in order);
- ``invalid_proofs``: the kinds of the distinct invalid proofs (``KINDS``),
  each made once from the fixture's proof;
- ``profile_calls``: calls in the traced run's steady profiled stretch;
- ``loop``: the loop that drives the window (``loops/<loop>.py``; today
  ``closed``, one caller);
- ``system``: the system under test that it calls (``systems/<system>.py``;
  today ``verify_batch``);
- ``env`` (optional): environment variables set for the program before it
  is loaded, such as ``{"PLONKY2_TPU_PB_IMPL": "cios"}``;
- ``loop_args`` (optional): parameters that the loop reads and checks
  itself, such as an open loop's rate.

A mix with any other key, or a kind not in ``KINDS``, is refused.

The seed draws every site of a corruption, which batches hold how many
invalid lanes (the mix's counts, shuffled), which lanes, and which invalid
proof each holds. Every seed gives the same sizes and the same kinds, so
it changes where the work lies and never how much there is. Every other
lane is the fixture's valid proof: the repository holds no prover.

Each corruption is made on the raw JSON and keeps every value canonical, so
the proof ingests and is rejected by the verifier, not at ingest.
"""

from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path

GL_P = (1 << 64) - (1 << 32) + 1
BN_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
OPENINGS = ("constants", "plonk_sigmas", "wires", "plonk_zs",
            "plonk_zs_next", "partial_products", "quotient_polys")


def _edit(tree, path, fn):
    """A copy of the JSON ``tree`` with ``fn`` applied at ``path`` (keys and
    indices); only the containers along the path are copied."""
    if not path:
        return fn(tree)
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[path[0]] = _edit(tree[path[0]], path[1:], fn)
    return out


def _flip_low_bit(bit):
    """x xor 2^bit for bit < 32, or x + 1 where that leaves the field."""
    def fn(x):
        y = int(x) ^ (1 << bit)
        return y if y < GL_P else (int(x) + 1) % GL_P
    return fn


def _add(delta, modulus):
    def fn(x):
        y = (int(x) + delta) % modulus
        return str(y) if isinstance(x, str) else y
    return fn


def opening(raw, rng):
    """One bit of one opened value (a seeded opening set, value, half and
    bit below 32)."""
    ops = raw["proof"]["openings"]
    key = rng.choice([k for k in OPENINGS if ops[k]])
    path = ["proof", "openings", key, rng.randrange(len(ops[key])),
            rng.randrange(2)]
    return _edit(raw, path, _flip_low_bit(rng.randrange(32))), path


def _round(raw, rng):
    rounds = raw["proof"]["opening_proof"]["query_round_proofs"]
    q = rng.randrange(len(rounds))
    return q, rounds[q], ["proof", "opening_proof", "query_round_proofs", q]


def leaf(raw, rng):
    """One element of one initial-tree leaf in a seeded query round and
    oracle, plus a seeded nonzero amount."""
    _, qr, base = _round(raw, rng)
    proofs = qr["initial_trees_proof"]["evals_proofs"]
    o = rng.randrange(len(proofs))
    path = base + ["initial_trees_proof", "evals_proofs", o, 0,
                   rng.randrange(len(proofs[o][0]))]
    return _edit(raw, path, _add(rng.randrange(1, 1 << 32), GL_P)), path


def sibling(raw, rng):
    """One Merkle sibling (a BN254 digest) of an initial tree or of a
    commit-phase step, in a seeded query round, tree and level."""
    _, qr, base = _round(raw, rng)
    trees = [base + ["initial_trees_proof", "evals_proofs", o, 1, "siblings"]
             for o in range(len(qr["initial_trees_proof"]["evals_proofs"]))]
    trees += [base + ["steps", j, "merkle_proof", "siblings"]
              for j in range(len(qr["steps"]))]
    tree = rng.choice(trees)
    node = raw
    for key in tree:
        node = node[key]
    path = tree + [rng.randrange(len(node))]
    return _edit(raw, path, _add(rng.randrange(1, 1 << 32), BN_P)), path


def pow_witness(raw, rng):
    """The FRI proof-of-work witness, moved by a seeded nonzero amount."""
    path = ["proof", "opening_proof", "pow_witness"]
    return _edit(raw, path, _add(rng.randrange(1, 1 << 16), GL_P)), path


def public_input(raw, rng):
    """One public input, moved by a seeded nonzero amount."""
    path = ["public_inputs", rng.randrange(len(raw["public_inputs"]))]
    return _edit(raw, path, _add(rng.randrange(1, 1 << 32), GL_P)), path


KINDS = {"opening": opening, "leaf": leaf, "sibling": sibling,
         "pow": pow_witness, "public_input": public_input}
MIX_KEYS = ("batch_size", "invalid_per_batch", "invalid_proofs",
            "profile_calls", "loop", "system")
OPTIONAL_MIX_KEYS = ("env", "loop_args")


def check_mix(mix, name):
    """Raise unless ``mix`` has every key of ``MIX_KEYS``, no key that is
    neither there nor in ``OPTIONAL_MIX_KEYS``, only kinds of ``KINDS``, and
    an ``env`` of strings and ``loop_args`` a mapping."""
    missing = [k for k in MIX_KEYS if k not in mix]
    unknown = sorted(set(mix) - set(MIX_KEYS) - set(OPTIONAL_MIX_KEYS))
    kinds = sorted(set(mix.get("invalid_proofs", [])) - set(KINDS))
    env = mix.get("env", {})
    if missing or unknown or kinds:
        raise ValueError(f"traffic mix {name!r}: missing {missing}, unknown "
                         f"keys {unknown}, unknown kinds {kinds}")
    if not (isinstance(env, dict) and all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env.items())):
        raise ValueError(f"traffic mix {name!r}: env must map names to "
                         f"strings")
    if not isinstance(mix.get("loop_args", {}), dict):
        raise ValueError(f"traffic mix {name!r}: loop_args must be a "
                         f"mapping")


@dataclasses.dataclass
class Plan:
    """What a run hands the system: ``proofs[k]`` the raw JSON of distinct
    proof k (0 the valid one) with ``vraw`` the verifier-only data, and
    ``batches[i][lane]`` the proof in each lane of distinct batch i."""
    proofs: list
    vraw: dict
    batches: list
    kinds: list  # kinds[k]: "valid" or the corruption of proof k
    sites: list  # sites[k]: the JSON path that was changed


def load_circuit(circuit_dir):
    """(proof JSON, verifier-only JSON) of a circuit directory."""
    circuit_dir = Path(circuit_dir)
    with open(circuit_dir / "proof_with_public_inputs.json") as f:
        raw = json.load(f)
    with open(circuit_dir / "verifier_only_circuit_data.json") as f:
        vraw = json.load(f)
    return raw, vraw


def make_plan(circuit_dir, mix, seed):
    """The seeded plan of one run of ``mix`` over the circuit's proof."""
    rng = random.Random(seed)
    raw, vraw = load_circuit(circuit_dir)
    proofs, kinds, sites = [raw], ["valid"], [None]
    for kind in mix["invalid_proofs"]:
        bad, path = KINDS[kind](raw, rng)
        proofs.append(bad)
        kinds.append(kind)
        sites.append(path)
    counts = list(mix["invalid_per_batch"])
    rng.shuffle(counts)
    pool = list(range(1, len(proofs)))
    slots = []
    while len(slots) < sum(counts):
        rng.shuffle(pool)
        slots += pool
    batches = []
    for count in counts:
        lanes = [0] * mix["batch_size"]
        for lane in rng.sample(range(mix["batch_size"]), count):
            lanes[lane] = slots.pop()
        batches.append(lanes)
    return Plan(proofs=proofs, vraw=vraw, batches=batches, kinds=kinds,
                sites=sites)
