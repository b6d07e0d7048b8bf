"""What the kinds of traffic share: the program's decoder settings from a
configuration file, the inputs the benchmark makes, the comparison, and
waiting for the device."""

from __future__ import annotations

import torch

from .reference.channel import seeded, zero_llrs
from .reference.codes import schedule_for
from .reference.decoder import Fixed, decode
from .yardstick import batch_seed


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_spec(config: dict, early_term: bool):
    """The program's ``LayeredSpec`` for the configuration."""
    from ldpcgputegra_tpu_torch.ops.layered import LayeredSpec

    return LayeredSpec(
        algo=config["algo"], iters=config["iters"], offset=config["offset"],
        early_term=early_term, minclamp=config["minclamp"],
        schedule=config["schedule"],
        sat_var=(1 << (config["var_bits"] - 1)) - 1,
        sat_msg=(1 << (config["msg_bits"] - 1)) - 1)


def program_decoder(config: dict, early_term: bool, device):
    """The decoder ``make_decoder`` returns for the configuration, and the
    backend it resolved to."""
    from ldpcgputegra_tpu_torch.codes.registry import load_code
    from ldpcgputegra_tpu_torch.decoder import backend_for, make_decoder

    code = load_code(config["code"])
    spec = program_spec(config, early_term)
    backend = backend_for(code, spec, device, config["backend"])
    return make_decoder(code, spec, backend=config["backend"],
                        device=device), backend


def make_inputs(config: dict, traffic: dict, seed: int, point: int,
                count: int, device) -> list:
    """``count`` LLR batches of the traffic's size and Eb/N0, batch i from
    a generator seeded ``batch_seed(seed, point, i)``."""
    return [zero_llrs(seeded(batch_seed(seed, point, i), device),
                      traffic["batch"], config["n"], config["k"],
                      traffic["ebn0_db"], config["quant_factor"],
                      config["bits_llr"], device) for i in range(count)]


def reference_decode(config: dict, root: str, llrs: list, early_term: bool,
                     **override):
    """The reference's decode of each of ``llrs``: [(bits, iters_used,
    frame_iters)].  ``override`` changes a setting (the control's
    ``msg_bits``)."""
    sched = schedule_for(config, root)
    fx = Fixed.of(config, early_term, **override)
    return [decode(sched, x, fx) for x in llrs]


def compared(name: str, value, limit) -> dict:
    return {"name": name, "value": value, "limit": limit}


def passes(numbers: list) -> bool:
    return all(c["value"] <= c["limit"] for c in numbers)


def check_decodes(config: dict, root: str, early_term: bool, inputs: list,
                  kept: dict, **override):
    """Held against the reference: the decodes ``kept`` ({call i: (bits,
    iters_used)}, call i decoded ``inputs[i % len(inputs)]``).  With
    ``override`` the reference at that setting stands in for the program
    (the control).  Returns the numbers compared (``decode_mismatch``: the
    bits that differ plus the calls whose ``iters_used`` differs), the
    calls that failed and the mean iterations a frame in the reference's
    decode."""
    n_in = len(inputs)
    used = sorted({i % n_in for i in kept})
    ref = dict(zip(used, _decode_each(config, root, [inputs[j] for j in used],
                                      early_term)))
    if override:
        ctl = dict(zip(used, _decode_each(
            config, root, [inputs[j] for j in used], early_term, **override)))
        kept = {i: ctl[i % n_in][:2] for i in kept}
    bits_bad = iters_bad = failed = 0
    for i, (bits, iters) in kept.items():
        rb, ri, _ = ref[i % n_in]
        nb = int((bits != rb).sum())
        ni = int(int(iters) != ri)
        bits_bad += nb
        iters_bad += ni
        failed += int(nb > 0 or ni > 0)
    per_frame = float(torch.cat([ref[j][2] for j in used]).float().mean())
    # one number: with ET off no precision moves iters_used, so it has no
    # reading of its own under the control
    return ([compared("decode_mismatch", bits_bad + iters_bad, 0)], failed,
            per_frame)


def _decode_each(config, root, llrs, early_term, **override):
    """``reference_decode`` of each of ``llrs``; without early termination
    (where a batch's iterations do not depend on the others) as one batch."""
    if early_term:
        return reference_decode(config, root, llrs, True, **override)
    bits, used, frame_iters = reference_decode(
        config, root, [torch.cat(llrs)], False, **override)[0]
    sizes = [x.shape[0] for x in llrs]
    return list(zip(bits.split(sizes), [used] * len(llrs),
                    frame_iters.split(sizes)))
