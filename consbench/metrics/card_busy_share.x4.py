"""card_busy_share.x4: the share of the window each card's device phases
covered, averaged over the cards: Σ over the window's calls of a card's
``busy_s`` (the union of its launches' event-timed device phases) over
the window's elapsed time, the mean of the four cards. A phase runs from
a launch's upload to its fetch, so it counts the gaps in which the card
waits for the host to enqueue the loop's rounds: an upper bound on the
card's kernel time, which the traced ``kernel_ms_per_cluster.batch``
gives summed over the cards."""
from consbench.cards import calls


def read(w):
    busy = calls(w, "busy_s")
    if busy is None:
        return None
    per_card = [sum(col) for col in zip(*busy)]
    return sum(per_card) / len(per_card) / w.elapsed_s
