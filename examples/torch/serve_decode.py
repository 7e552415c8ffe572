"""Serving example: batched requests through the length-sorted scheduler,
top-k sampled decode on the port's sorting kernels.

On the card (the default) each batch's decode steps replay one captured
CUDA graph (``launch.steps.DecodeGraph``) and the top-k of the sampling
runs the top-k kernel (K5); ``--device cpu`` runs the same static step
uncaptured, on the plain versions.

Run:  PYTHONPATH=src python examples/torch/serve_decode.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve

ARGS = dict(smoke=True, n_requests=20, batch_size=8, decode_steps=24,
            topk=20)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="serve gemma-2b (smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = ap.parse_args(argv).device
    done, stats = serve("gemma-2b", **ARGS, device=dev)
    for r in done[:3]:
        print(f"request {r.rid}: prompt len {len(r.prompt)}, "
              f"generated {r.out[:10].tolist()}...")
    return {"done": done, "stats": stats}


if __name__ == "__main__":
    main()
