"""Fault tolerance demo, on the card: train, 'crash', auto-resume from the
latest valid checkpoint, finish, with identical data order after the
restart.

    PYTHONPATH=src python examples/torch/fault_tolerant_train.py [--device cpu]

Checkpoints go to a fresh directory under ``build/`` in the checkout,
removed at the end.
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch.train import train_loop

BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")


def main(device="cuda"):
    os.makedirs(BUILD, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_", dir=BUILD)
    print(f"checkpoints -> {ckpt_dir}")
    try:
        print("\n=== phase 1: run 12 of 24 steps, checkpoint every 5, then 'crash' ===")
        train_loop("stablelm-3b", steps=12, batch=4, seq=16,
                   ckpt_dir=ckpt_dir, ckpt_every=5, device=device)

        print("\n=== phase 2: relaunch the same job — it resumes automatically ===")
        r2 = train_loop("stablelm-3b", steps=24, batch=4, seq=16,
                        ckpt_dir=ckpt_dir, ckpt_every=5, device=device)
        assert r2.resumed_from is not None
        print(f"\nresumed from step {r2.resumed_from}; "
              f"ran only {r2.steps_run} remaining steps; "
              f"final loss {r2.final_loss:.4f}")
    finally:
        shutil.rmtree(ckpt_dir)
    return r2


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
