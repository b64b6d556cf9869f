"""Model FLOPs of the traced passes' predict steps and their scoring
over the traced seconds at the bf16 dense peak of the cell's cards, in
percent."""
from counts import BF16_FLOPS_PER_S


def read(view):
    if view.kind != "predict" or view.window_s <= 0 or not view.flops:
        return None
    return 100.0 * view.flops / (view.window_s * view.cards
                                 * BF16_FLOPS_PER_S)
