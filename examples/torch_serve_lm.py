"""Batched serving example on the PyTorch port: prefill a batch of prompts,
then decode with the one-token serve step (greedy) against the
preallocated KV cache (``examples/serve_lm.py``'s run, on the card, at
the architecture's reduced config as there), through the serve
launcher's ``run``.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch deepseek_7b --tokens 24
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    """Returns ``(exit code, the numbers printed)``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="deepseek_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    out = serve.run(get_config(args.arch).reduced(), args.batch, args.prompt_len, args.tokens,
                    args.device)
    print(f"[serve] sample generations (token ids): {out['tokens'][0, :10].tolist()} ...")
    return 0, out


if __name__ == "__main__":
    sys.exit(main()[0])
