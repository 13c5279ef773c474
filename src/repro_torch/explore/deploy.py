"""From exploration result to deployment config.

The explorer searches over cut positions in the *layer-graph schedule*
(Embed, Attention_0, FFN_0, Attention_1, ...); the serving runtime
partitions a decoder LM at *block* boundaries (stage k = a contiguous
range of transformer blocks).  This module is the bridge: it maps the
Def.-2 selected cuts of an :class:`ExplorationResult` onto the block
boundaries ``PartitionedLMRunner`` actually deploys.
"""

from __future__ import annotations

from typing import List, Sequence


def lm_block_cuts(cuts: Sequence[int], n_layers: int) -> List[int]:
    """Map explorer cut positions (schedule indices over the LM layer
    graph: Embed, then Attention_i/FFN_i pairs) to decoder block cut
    indices for ``PartitionedLMRunner`` (``cuts=[b]`` = stage boundary
    after block ``b``).

    Position ``-1`` encodes "no cut" and is dropped; cuts inside a block
    (between its attention and FFN) snap to the end of that block; the
    result is clamped so every stage keeps at least one block.  An empty
    result falls back to the middle of the stack, so callers always get a
    deployable >= 2-stage split.
    """
    if n_layers < 2:
        raise ValueError("partitioned serving needs >= 2 blocks")
    out: List[int] = []
    for c in cuts:
        if c < 0:
            continue
        b = max(0, min(n_layers - 2, (int(c) - 1) // 2))
        if b not in out:
            out.append(b)
    return sorted(out) or [max(0, n_layers // 2 - 1)]
