"""One acxrun rank of a mixed JAX/torch partitioned exchange.

Run: ``build/acxrun -np 2 python tests/torch_mixed_worker.py --jax-rank R
[torch worker arguments]``. The rank whose ``ACX_RANK`` is R becomes the JAX
package's tests/device_bridge_worker.py, the other the port's
tests/torch_bridge_worker.py with the remaining arguments: the flag words
and the wire are the contract the two packages share. The process is
replaced (``exec``), so the rank keeps the transport that acxrun handed it.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax-rank", type=int, required=True)
    args, rest = ap.parse_known_args()
    if int(os.environ["ACX_RANK"]) == args.jax_rank:
        argv = [os.path.join(HERE, "device_bridge_worker.py")]
    else:
        argv = [os.path.join(HERE, "torch_bridge_worker.py"), *rest]
    os.execv(sys.executable, [sys.executable, *argv])


if __name__ == "__main__":
    main()
