"""chip_smoke.py's later phases alone, on the card: the build (phase 1),
the threefry rows of phase 2, the decode serving of phase 3 where phase
57 is named (it reads phase 3's parameters, prompts and served chains),
then the phases named on the command line (default 55-62):

    python3 tools/slice_phases.py [9] [55] [56] [57] [58] [59] [60] [61] [62]

9: the bench LM fit (phase 60 prints its tokens/s beside it); 55: the
bench LM through kill and resume; 56: ResNet-50 through kill and resume;
57: the Predictor (58, a warm restart, needs 57); 59: the 16-bit
samplers; 60: the tensor surface (every op name card vs CPU, the bench LM
through a loss written in the ops); 61: the remaining nn layers and losses
card vs CPU, and DCGAN through two Modules; 62: the contrib ops card vs
CPU, SSD's fit and decode, MultiProposal and CTC at realistic shapes."""
import os
import sys

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    tick = cs._PhaseClock()
    smi = cs.phase_build(ck)
    print(smi)
    tick("1 (build)")
    rec = {}
    rs = np.random.RandomState(0)
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to("cuda", dtype)
    calls = cs._threefry_kernels(ck, rs, t, rec)
    for name in ("uniform_bf16", "uniform_f16", "uniform"):
        r = rec[name]
        dev_ms = cs._device_ms(calls[name])
        print(f"kernel {name}: max_abs_err={r['max_abs_err']} "
              f"kernel_ms={r['ms']:.5f} device_ms={dev_ms} "
              f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']} "
              f"library_device_ms={cs._device_ms(r['library_call'])} "
              f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})")
    tick("2j (threefry)")
    only = sys.argv[1:] or ["55", "56", "57", "58", "59", "60", "61", "62"]
    if "57" in only:
        serve_counts, sym, params, prompts, served = cs.phase_serve(mx, ck)
        tick("3 (serve)")
    if "9" in only:
        cs.phase_lm_train(mx, ck)
        tick("9")
    if "55" in only:
        cs.phase_lm_resume(mx, ck)
        tick("55")
    if "56" in only:
        cs.phase_resnet_resume(mx, ck)
        tick("56")
    if "57" in only:
        c, srv, reqs, outs = cs.phase_predictor(mx, ck, params, prompts,
                                                served)
        tick("57")
        if "58" in only:
            cs.phase_warm_restart(mx, ck, srv, reqs, outs)
            tick("58")
    if "59" in only:
        cs.phase_samplers16(mx, ck)
        tick("59")
    if "60" in only:
        cs.phase_tensor_surface(mx)
        cs.phase_custom_loss(mx, ck)
        tick("60")
    if "61" in only:
        cs.phase_nn_layers(mx)
        cs.phase_dcgan(mx, ck)
        tick("61")
    if "62" in only:
        cs.phase_ssd(mx, ck)
        tick("62")
    print("new phases: ok")


if __name__ == "__main__":
    main()
