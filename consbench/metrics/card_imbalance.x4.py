"""card_imbalance.x4: how uneven the cards' device phases are, the mean
over the window's calls of the longest card's ``busy_s`` over the cards'
mean (1: even). The phases include the gaps in which a card waits for
the host's enqueue (``card_busy_share.x4``), so the ratio reads the
host's pace per card as well as each card's work."""
from consbench.cards import calls


def read(w):
    busy = calls(w, "busy_s")
    if busy is None:
        return None
    ratios = [max(b) * len(b) / sum(b) for b in busy if sum(b) > 0]
    return sum(ratios) / len(ratios) if ratios else None
