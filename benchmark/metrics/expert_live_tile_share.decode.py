"""expert_live_tile_share.decode: how much of the grouped expert kernels'
slot grid the traced batch's decode worked on: the m16 slot tiles that
held routed rows over all of them, in %, from the `generate.decode` span's
`expert_tiles_live` and `expert_tiles` attributes (summed over every MoE
layer and step on the device by the gate/up launch, zeroed before the
decode). A program that keeps no such attributes reads nothing."""
from benchmark.metrics import _offline_spans


def read(run):
    found = _offline_spans.spans(run, "generate.decode")
    if not found or len(found) != 1:
        return None
    attrs = found[0].attrs or {}
    if not attrs.get("expert_tiles"):
        return None
    return 100.0 * attrs["expert_tiles_live"] / attrs["expert_tiles"]
