#!/usr/bin/env python3
"""K1's output bits at the 7 DCN shapes of DLA-34 at 512² (batch 2, f32 and
bf16, offsets 0, ~1, ~8 and ~40 px, with the eval epilogue and with a bias)
for the checkout on PYTHONPATH, on the card: one SHA-256 per case (112),
appended as one JSON line to the file named. Two checkouts' lines hold the
same hashes when K1 gives the same bits; to compare, unpack one with
``git archive`` into a directory git ignores and run both in one call::

    for t in output/parent .; do
        PYTHONPATH=$t python3 detectron2_centernet_tpu_torch/tools/dcn_bits.py output/dcn_bits.jsonl; done
"""
import hashlib
import json
import sys

import torch

from detectron2_centernet_tpu_torch.ops import dcn

SHAPES = [(512, 256, 16), (256, 256, 32), (256, 128, 32), (256, 64, 32), (128, 128, 64), (128, 64, 64), (64, 64, 128)]


def main(path: str) -> None:
    out = {}
    for cin, cout, hw in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for regime, reach in (("zero", 0.0), ("1px", 1.0), ("8px", 8.0), ("40px", 40.0)):
                g = torch.Generator(device="cuda").manual_seed(cin + cout + hw)
                n = lambda *s: torch.randn(*s, generator=g, device="cuda")
                x = n(2, cin, hw, hw).to(dtype)
                offset = n(2, 18, hw, hw) * reach
                mask = torch.rand(2, 9, hw, hw, generator=g, device="cuda")
                weight = (n(cout, cin, 3, 3) / (9 * cin) ** 0.5).to(dtype)
                s, t = torch.rand(cout, generator=g, device="cuda") + 0.5, n(cout) * 0.1
                for epilogue in (False, True):
                    kw = dict(post_scale=s, post_shift=t, post_relu=True) if epilogue else dict(bias=t)
                    y = dcn.modulated_deform_conv(x, offset, mask, weight, **kw)
                    torch.cuda.synchronize()
                    key = f"{cin}->{cout}@{hw} {str(dtype)[6:]} {regime} {'epilogue' if epilogue else 'bias'}"
                    out[key] = hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()
    with open(path, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(len(out), "cases hashed")


if __name__ == "__main__":
    main(sys.argv[1])
