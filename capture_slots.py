"""The instrument over UDP at several capture slot sizes, on one CUDA card.

    python3 capture_slots.py [--slots 16,256,4096] [--rate 100000]

Runs `Service(lwa_instrument_spec(sock=rx, capture=dict(nsrc=4,
max_payload_size=256, slot_ntime=S, buffer_ntime=...)))` at the flagship
width (chip_smoke.py's constants) on the first `chip_smoke.CP_NINT`
integrations of chip_smoke's [bengine] voltages, the packets sent over
loopback by the port's schedule walker at `--rate` packets/s, once for
each slot size S, and prints for each the walker's stats, the capture's
packet counters, the images out and the wall time.  The capture engine
reserves and commits its ring in C without the GIL (it enters Python
once a sequence, for the header), so a small slot costs ring calls, not
waits on the instrument's host threads; what the socket buffer cannot
hold shows as `nmissing`.  Prints the card's name and power limit
first.
"""

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", default="16,256,4096")
    ap.add_argument("--rate", type=int, default=cs.CP_X_RATE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("capture_slots: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    from bifrost_tpu_torch import build
    from bifrost_tpu_torch.service import Service, lwa_instrument_spec
    build.build_all()
    rng = np.random.default_rng(cs.SEED)
    block = rng.integers(-8, 8, (cs.B_REPLAY * cs.B_GULP, cs.NSTAND,
                                 cs.NPOL, 2), dtype=np.int8)
    volt = block[:cs.CP_NINT * cs.B_GULP].copy()
    del block
    frames = volt.reshape(len(volt), -1).view(np.uint8)
    for slot in (int(x) for x in args.slots.split(",")):
        slab, recs = cs.cp_packets(frames, 4, args.rate)
        rx, rcvbuf = cs.cp_socket()
        imgs = cs.Fingerprints(0)
        spec = lwa_instrument_spec(
            sock=rx, capture=dict(nsrc=4, max_payload_size=256,
                                  slot_ntime=slot, buffer_ntime=len(volt)),
            nstand=cs.NSTAND, npol=cs.NPOL, nchan=cs.BCHAN, ntap=cs.NTAP,
            n_int=cs.N_INT, nbeam=cs.NBEAM, max_delay=cs.B_MAX_DELAY,
            ngrid=cs.NGRID, f0_mhz=cs.B_F0, dt_s=cs.B_DT,
            gulp_nframe=cs.B_GULP, on_image=imgs)
        svc = Service(spec, name=f"slots_{slot}", device=dev)
        t0 = time.perf_counter()
        c = cs.cp_drive(svc, svc.blocks["ingest"], rx, slab, recs)
        print(f"[slots] slot_ntime {slot} ({4 * slot} packets a window), "
              f"asked {args.rate} packets/s, SO_RCVBUF {rcvbuf} B: walker "
              f"{c['walk']}; stats {c['stats']}; {len(imgs.sums)} images; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del svc, slab, recs, imgs
        cs.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
