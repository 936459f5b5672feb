"""Where the serving engine's greedy tokens part from solo generation, on one CUDA card.

    python3 tools/torch_serve_divergence.py

``chip_smoke.py``'s serve phase requires each greedy request's tokens from
``Scheduler`` -> ``DecodeEngine`` to equal the port's solo ``gpt_generate``
except where solo's top-2 logit margin is below its near-tie bound. This
tool takes the same model (GPT-2-small width, random weights from seed 0,
bf16), the same requests and the same engine settings (``chip_smoke``'s
``SERVE_*`` constants; the sampled requests are skipped here) and reports,
as JSON lines:

- for each greedy request, the first token where the engine and solo
  differ and solo's top-2 margin there (``chip_smoke.greedy_margin``), with
  all requests in the serve phase's engine, each request alone in it, and
  each alone in a 1-slot engine;
- whether a prefill padded to the engine's default bucket, and one padded
  to a power of two (the JAX engine's buckets), give hidden states and K/V
  bitwise equal to the solo prefill.

Prints the card's name and power limit last.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def first_divergence(engine_tokens, params, cfg, prompt):
    """None when the engine's tokens equal solo gpt_generate's, else
    [first differing token, solo's top-2 margin there]."""
    from ray_lightning_tpu_torch.models import gpt

    solo = gpt.gpt_generate(params, cfg, [prompt], chip_smoke.SERVE_NEW,
                            device="cuda")
    solo = solo[0, len(prompt):].tolist()
    if engine_tokens == solo:
        return None
    j = next(j for j, (a, b) in enumerate(zip(engine_tokens, solo)) if a != b)
    return [j, chip_smoke.greedy_margin(params, cfg, prompt + solo[:j])]


def serve(params, cfg, prompts, which, **engine_kw):
    """Greedy tokens of the requests ``which`` through the serve phase's
    engine (``engine_kw`` overrides its settings) behind the scheduler, by
    request index."""
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

    engine = DecodeEngine(params, cfg, device="cuda",
                          **dict(chip_smoke.SERVE_ENGINE, **engine_kw))
    sched = Scheduler(engine)
    for i in which:
        sched.submit(prompts[i],
                     SamplingParams(max_new_tokens=chip_smoke.SERVE_NEW),
                     request_id=str(i))
    toks = {i: [] for i in which}
    for ev in sched.run_until_idle():
        if ev.token is not None:
            toks[int(ev.request_id)].append(ev.token)
    return toks


def main():
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.serve.engine import default_buckets

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    lengths = chip_smoke.SERVE_LENGTHS
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    greedy = [i for i in range(len(lengths)) if i not in chip_smoke.SERVE_SAMPLED]

    with torch.no_grad():
        # The serve phase itself: all requests (sampled ones too) at once.
        toks = serve(params, cfg, prompts, range(len(lengths)))
        print(json.dumps({"config": "all requests", "first_divergence": {
            f"r{i}": first_divergence(toks[i], params, cfg, prompts[i])
            for i in greedy}}), flush=True)
        for slots in (chip_smoke.SERVE_ENGINE["num_slots"], 1):
            out = {}
            for i in greedy:
                toks = serve(params, cfg, prompts, [i], num_slots=slots)
                out[f"r{i}"] = first_divergence(toks[i], params, cfg,
                                                prompts[i])
            print(json.dumps({"config": f"each request alone, {slots} "
                              f"slot(s)", "first_divergence": out}),
                  flush=True)

        buckets = default_buckets(chip_smoke.SERVE_ENGINE["max_seq"])
        for name, pad_to in (
            ("default bucket", lambda n: min(b for b in buckets if b >= n)),
            ("power of two", lambda n: max(16, 1 << (n - 1).bit_length())),
        ):
            same = {}
            for i in greedy:
                n, padded_n = lengths[i], pad_to(lengths[i])
                pr = torch.tensor([prompts[i]], device="cuda")
                pad = torch.zeros((1, padded_n - n), dtype=torch.long,
                                  device="cuda")
                h1, k1, v1 = gpt.gpt_prefill(params, cfg, pr)
                h2, k2, v2 = gpt.gpt_prefill(params, cfg,
                                             torch.cat([pr, pad], 1))
                same[f"r{i} ({n} of {padded_n})"] = bool(
                    torch.equal(h1, h2[:, :n])
                    and torch.equal(k1, k2[:, :, :n])
                    and torch.equal(v1, v2[:, :, :n]))
            print(json.dumps({f"prefill bitwise equal, solo vs padded to "
                              f"the {name}": same}), flush=True)
    print(f"[card] {chip_smoke.card_line()}")


if __name__ == "__main__":
    main()
