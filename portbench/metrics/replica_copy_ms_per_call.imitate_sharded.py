"""Device milliseconds of peer and device-to-device copies per sharded call,
summed over the cards: `parallel/inference.sharded_synthesize` copies the
composer, the generator and the source cache to every other card on every
call, its slice of SMPLs out and its frames back onto the first card."""
import re

from portbench.lib.trace import device_seconds

COPIES = re.compile(r"^Memcpy (PtoP|DtoD)")


def read(run):
    calls = run.counters.get("requests", 0)
    spent = device_seconds(run.kernels, lambda n: bool(COPIES.match(n)))
    if not calls or spent <= 0:
        return None
    return 1e3 * spent / calls
