"""FRI's Poseidon-BN254 hash chains: every leaf sponge and Merkle climb of a
verification, as one plan of chain kinds.

Counterpart of the two ``lax.scan`` loops of ``plonky2_tpu/fri/verify.py``
(``_hash_leaves_scan`` at :101 and ``_merkle_chain`` at :68), which hash a
query round's leaves and climb from each leaf digest to a cap entry.  A
chain is one (proof, query round, kind); a kind is an initial oracle's tree
or a reduction step's tree.  A chain absorbs its leaf's blocks (HashNoPad:
slot 0 kept, the masked slots 1..3 replaced by the block; none for a
HashOrNoop oracle, whose packed leaf is its digest), then climbs its tree
(the sibling ordered by one bit of the query index, permute [0, 0, left,
right]); its root is element 0 of its last state.

A chain absorbs its leaf as blocks of BN254 elements in Montgomery form,
each of up to 3 Goldilocks elements packed into one integer (sum v_k
2^(64 k); reference poseidon/bn254.go:47-77).  ``leaf_blocks`` builds them
from the batch's own leaves (the initial oracles' ``init_leaves_<o>``, each
step's ``step<j>_evals``): on a CUDA tensor one launch of the block
builder (``kernels/fri_leaves``), on a CPU tensor ``leaf_blocks_plain``.
So the Merkle check hashes the very elements FRI's evaluation check reads,
and no derived copy of them travels from the host.

``merkle_plan`` describes the kinds once per circuit, and ``slot_plan``
orders them, or packs them into lane slots that run several kinds back to
back, for the chain kernels' launch (``kernels/fri_merkle
.launch_geometry``).  ``merkle_roots`` gives every chain's root: on a CUDA
tensor one launch of the chain kernel of the selected permutation form
(``kernels/fri_merkle``, ``hash/poseidon_bn254.kernel_impl``), on a CPU
tensor ``merkle_roots_plain``, which runs every chain time-step-major in
plain torch: at step t one ``permute_plain`` over every chain still
running.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fields import bn254
from ..fields import goldilocks as gl
from ..hash import poseidon_bn254 as pb
from ..proof.serde import absorb_slot_masks, leaf_layout


@dataclasses.dataclass(frozen=True)
class ChainKind:
    """One kind of chain over a batch's (B, Q) lanes.

    ``leaf_key`` names the leaf blocks in the tensor dict, (B, Q, T, 3, 16)
    (an initial oracle's at index ``oracle`` of axis 2 of
    ``init_leaf_packed``; ``leaf_blocks`` makes them); ``steps`` absorb
    steps (0 for HashOrNoop), whose ``mask`` has bit 3 t + s set where
    step t absorbs slot s; ``sib_key`` the siblings, (B, Q, depth, 16) (an
    oracle's at ``oracle`` of axis 2); level l reads bit ``offset + l`` of
    the query index."""
    name: str
    leaf_key: str
    oracle: int | None
    steps: int
    mask: int
    sib_key: str
    depth: int
    offset: int

    @property
    def length(self):
        """Permutations a chain of this kind runs."""
        return self.steps + self.depth

    def slot_mask(self):
        """The mask as (steps, 3) bool."""
        bits = [(self.mask >> i) & 1 for i in range(3 * self.steps)]
        return np.asarray(bits, dtype=bool).reshape(self.steps, 3)

    def leaves(self, dev):
        """The kind's leaf blocks in ``dev``, a (B, Q, max(steps, 1), 3, 16)
        view."""
        t = dev[self.leaf_key]
        if self.oracle is not None:
            t = t[:, :, self.oracle]
        return t[:, :, :max(self.steps, 1)]

    def siblings(self, dev):
        """The kind's siblings in ``dev``, a (B, Q, depth, 16) view."""
        t = dev[self.sib_key]
        return t if self.oracle is None else t[:, :, self.oracle]


def _mask_bits(slot_mask):
    return sum(1 << i for i, v in enumerate(np.asarray(slot_mask).reshape(-1))
               if v)


@functools.lru_cache(maxsize=16)
def merkle_plan(spec):
    """The chain kinds of a verification of ``spec``: the four initial
    oracles' trees (roots 0..3, depth ``initial_tree_depth``, from bit 0 of
    the query index), then each reduction step's tree (root 4 + j, from bit
    sum(arity_bits[:j + 1]): a step climbs on its coset's bits).  Every
    query window of the circuit (``fri.verify.query_rounds``) has the same
    plan: a window only sets how many rounds a batch's lanes hold."""
    layout = leaf_layout(spec)
    kinds = []
    for o in range(4):
        steps = 0 if layout.noop[o] else layout.n_steps[o]
        kinds.append(ChainKind(
            f"oracle{o}", "init_leaf_packed", o, steps,
            _mask_bits(layout.slot_mask[o, :steps]), "init_siblings",
            spec.initial_tree_depth, 0))
    offset = 0
    for j, arity_bits in enumerate(spec.reduction_arity_bits):
        offset += arity_bits
        mask = absorb_slot_masks((1 << arity_bits) * 2)
        kinds.append(ChainKind(
            f"step{j}", f"step{j}_leaf_packed", None, mask.shape[0],
            _mask_bits(mask), f"step{j}_siblings", spec.step_tree_depths[j],
            offset))
    return tuple(kinds)


def slot_plan(plan, pack=False):
    """Slot types over the plan: a tuple of tuples of indices into
    ``plan``, longest first (ties in plan order).  A lane slot of type
    ``(k0, k1, ...)`` runs its lane's chain of kind k0, then its chain of
    kind k1, ..., back to back.  Without ``pack`` each kind is a type of
    its own.  With it the kinds are packed first fit, longest first, into
    types whose lengths add up to at most the longest kind's: on step
    [oracle1], [oracle0], [oracle2, step0], [oracle3, step1] (28, 22, 27
    and 22 permutations; 88 % of the 4 x 28 slot steps busy, against 59 %
    of 6 x 28).  A pure function of its arguments."""
    order = sorted(range(len(plan)), key=lambda k: -plan[k].length)
    if not pack:
        return tuple((k,) for k in order)
    cap = plan[order[0]].length if order else 0
    bins = []
    for k in order:
        for b in bins:
            if slot_length(plan, b) + plan[k].length <= cap:
                b.append(k)
                break
        else:
            bins.append([k])
    return tuple(tuple(b) for b in bins)


def slot_length(plan, kinds):
    """Permutations a lane slot of the type ``kinds`` runs."""
    return sum(plan[k].length for k in kinds)


@dataclasses.dataclass(frozen=True)
class LeafSource:
    """One leaf's Goldilocks elements and the absorb blocks made of them.

    ``key`` names the elements in the tensor dict: an initial oracle's
    ``init_leaves_<o>``, a GL pair (B, Q, n), or a reduction step's
    ``step<j>_evals``, a QE pair (B, Q, n / 2) read (c0, c1) an eval
    (``comps`` 2), as ingest flattens them.  Its ``n`` elements fill
    ``steps`` blocks of 3 slots of 3 elements in order, zeros past the
    last; the blocks go to index ``oracle`` of axis 2 of ``block_key``'s
    (B, Q, 4, steps, 3, 16), or for a step to ``block_key``'s (B, Q,
    steps, 3, 16), as ingest laid out ``init_leaf_packed`` and
    ``step<j>_leaf_packed``."""
    key: str
    n: int
    comps: int
    block_key: str
    oracle: int | None
    steps: int


@functools.lru_cache(maxsize=16)
def leaf_sources(spec):
    """The leaves of a verification of ``spec``, in ``merkle_plan``'s
    order: the four initial oracles' (``max_steps`` blocks each, the steps
    past an oracle's own and a HashOrNoop oracle's slots past 0 zero), then
    each reduction step's."""
    layout = leaf_layout(spec)
    out = [LeafSource(f"init_leaves_{o}", size, 1, "init_leaf_packed", o,
                      layout.max_steps)
           for o, size in enumerate(spec.oracle_leaf_sizes)]
    for j, arity_bits in enumerate(spec.reduction_arity_bits):
        n = (1 << arity_bits) * 2
        out.append(LeafSource(f"step{j}_evals", n, 2, f"step{j}_leaf_packed",
                              None, absorb_slot_masks(n).shape[0]))
    return tuple(out)


def leaf_planes(src, dev):
    """The 32-bit word planes of ``src``'s elements in ``dev``: ((lo, hi),)
    for an oracle's leaves, ((lo, hi), (lo, hi)) of c0 and c1 for a step's
    evals, each (B, Q, n / comps) int64."""
    v = dev[src.key]
    return (v,) if src.comps == 1 else v


# R^2 mod p: a Montgomery product by it takes x to x R mod p, its
# Montgomery form
R2_LIMBS = bn254.int_to_limbs(bn254.R * bn254.R)


def pack_blocks_plain(planes, steps):
    """Plain torch: the absorb blocks of one leaf, (B, Q, steps, 3, 16)
    canonical Montgomery limbs, from its word planes (``leaf_planes``): the
    elements in order (c0, c1 an eval where two planes are given), zeros
    past the last, 3 a slot packed into sum v_k 2^(64 k) (below 2^192 < p),
    then one Montgomery product by R^2.  What ingest's ``_pack_leaf_mont``
    gives, the empty slots zero."""
    lo = torch.stack([p[0] for p in planes], -1).flatten(-2)
    hi = torch.stack([p[1] for p in planes], -1).flatten(-2)
    pad = 9 * steps - lo.shape[-1]
    words = torch.stack([torch.nn.functional.pad(lo, (0, pad)),
                         torch.nn.functional.pad(hi, (0, pad))], -1)
    words = words.reshape(lo.shape[:-1] + (steps, 3, 6))  # lo0 hi0 .. hi2
    limbs = torch.stack([words & 0xFFFF, words >> 16], -1).flatten(-2)
    limbs = torch.nn.functional.pad(limbs, (0, 16 - limbs.shape[-1]))
    return bn254.mont_mul(limbs, gl.device_table(R2_LIMBS, lo.device))


def leaf_blocks_plain(spec, dev):
    """Plain torch: {block key: int64 blocks} of every leaf of ``spec``
    (``leaf_sources``) from the leaves in ``dev``: ``init_leaf_packed``,
    (B, Q, 4, max_steps, 3, 16), and each ``step<j>_leaf_packed``, (B, Q,
    steps, 3, 16), canonical Montgomery limbs, bit for bit what ingest
    makes of the same leaves (widened)."""
    out = {}
    for src in leaf_sources(spec):
        out.setdefault(src.block_key, []).append(
            pack_blocks_plain(leaf_planes(src, dev), src.steps))
    return {k: torch.stack(v, dim=2) if k == "init_leaf_packed" else v[0]
            for k, v in out.items()}


def leaf_blocks(spec, dev):
    """The blocks of ``leaf_blocks_plain``: on a CUDA tensor one launch of
    the block builder (``kernels/fri_leaves.leaf_blocks``), which raises
    if it cannot; the plain version only on a CPU tensor."""
    if dev["init_leaves_0"][0].device.type == "cpu":
        return leaf_blocks_plain(spec, dev)
    from ..kernels import fri_leaves as kl
    return kl.leaf_blocks(spec, dev)


def _bit(x_index, bit):
    """Bit ``bit`` of the query index, a GL pair of 32-bit words, as bool."""
    return ((x_index[bit >> 5] >> (bit & 31)) & 1).bool()


def _step_input(kind, state, t, dev, x_index, mask):
    """The state chain ``kind`` permutes at its step t: its absorb of block t
    (slot 0 kept, the masked slots replaced), else its level t - steps
    ([0, 0, left, right] around its digest, state element 0)."""
    if t < kind.steps:
        rest = torch.where(mask[t][:, None], kind.leaves(dev)[:, :, t],
                           state[..., 1:, :])
        return torch.cat([state[..., :1, :], rest], dim=-2)
    level = t - kind.steps
    cur = state[..., 0, :]
    sib = kind.siblings(dev)[:, :, level]
    m = _bit(x_index, kind.offset + level)[..., None]
    z = torch.zeros_like(cur)
    return torch.stack([z, z, torch.where(m, sib, cur),
                        torch.where(m, cur, sib)], dim=-2)


def merkle_roots_plain(plan, dev, x_index):
    """Plain torch: every chain's root, (B, Q, len(plan), 16) canonical
    Montgomery limbs, root k of chain kind ``plan[k]``.  ``dev``: the
    tensor dict; ``x_index``: the query indices, a GL pair (B, Q).  Step t
    is one ``permute_plain`` over every chain still running, the schedule
    the kernels run; each chain computes what ``fri.verify
    ._hash_leaves_scan`` then ``_merkle_chain`` compute."""
    B, Q = x_index[0].shape
    device = x_index[0].device
    states = []
    for kind in plan:
        st = torch.zeros((B, Q, pb.WIDTH, 16), dtype=torch.int64, device=device)
        if kind.steps == 0:  # HashOrNoop: the packed leaf is the digest
            st[..., 0, :] = kind.leaves(dev)[:, :, 0, 0]
        states.append(st)
    masks = [gl.device_table(kind.slot_mask(), device) for kind in plan]
    for t in range(max(kind.length for kind in plan)):
        running = [k for k, kind in enumerate(plan) if t < kind.length]
        ins = torch.stack([_step_input(plan[k], states[k], t, dev, x_index,
                                       masks[k]) for k in running], dim=2)
        for k, st in zip(running, pb.permute_plain(ins).unbind(2)):
            states[k] = st
    return torch.stack([st[..., 0, :] for st in states], dim=2)



def merkle_roots(plan, dev, x_index):
    """Every chain's root, as ``merkle_roots_plain``: on a CUDA tensor one
    launch of the chain kernel of ``pb.kernel_impl()``'s form (kernel A's
    under ``mxu``, the CIOS form's under ``cios``), which raises if it
    cannot; the plain version only on a CPU tensor."""
    if x_index[0].device.type == "cpu":
        return merkle_roots_plain(plan, dev, x_index)
    from ..kernels import fri_merkle as kf
    kernel = kf.chains_cios if pb.kernel_impl() == "cios" else kf.chains_a
    return kernel(plan, dev, x_index)
