"""plan_card_share: the share, in %, of the sources that the banded
engine's set-up ordered (the program's counter plan.src in its "plan"
spans) whose spatial order, and node fluxes where the truth-amps path
takes them, a CUDA device made with no host pass over the sources (the
counter plan.src_card), in the window's first simulation. 100 where the
whole plan's per-source work ran on the card; nothing where the program
counts no plan.src (a program older than the counters) or the banded
engine does not run. Moves vis_rate."""

from gpubench import spans

LAYER = "driver.banded_engine: banded plan and snapshot functions"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "vis_rate"


def read(info):
    tr = spans.of(info)
    if tr is None:
        return None
    done = card = 0
    for plan in tr.named("plan"):
        done += tr.total(plan, "plan.src")
        card += tr.total(plan, "plan.src_card")
    return 100.0 * card / done if done else None
