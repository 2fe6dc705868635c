"""Data-parallel training through ``DistriOptimizer`` in one script
(``bigdl_tpu/examples/distributed_pod.py``): LeNet-5 on seeded random
images over the ranks of a ``torch.distributed`` group, the compressed
gradient exchange, validation merged across the ranks, checkpoints with
preemption handling and resume, and optionally the block-store mode with
the straggler drop.

One process per device. On one card (a one-rank NCCL group):

    python3 -m bigdl_tpu_torch.examples.distributed_pod -b 64 --maxIteration 20

Two ranks on a CPU box (gloo), under torchrun:

    torchrun --nproc_per_node 2 -m bigdl_tpu_torch.examples.distributed_pod \\
        --device cpu -b 64 --checkpoint /tmp/ckpt

or as plain processes, one per rank, meeting at a shared file:

    python3 -m bigdl_tpu_torch.examples.distributed_pod --device cpu \\
        --coordinator file:///tmp/rdv --nProcs 2 --procId $RANK

``--checkpoint`` writes ``<dir>/proc_<rank>`` snapshots every 5 iterations
(a SIGTERM writes one and exits; ``--resume`` continues from them).
Straggler mode: ``--parameterMode blockstore --dropPercentage 0.05``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    import numpy as np
    import torch

    p = argparse.ArgumentParser(description="data-parallel training example")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous: host:port, tcp://... or file://...")
    p.add_argument("--nProcs", type=int, default=1)
    p.add_argument("--procId", type=int, default=0)
    p.add_argument("-b", "--batchSize", type=int, default=64,
                   help="GLOBAL batch size (reference semantics)")
    p.add_argument("--learningRate", type=float, default=0.05)
    p.add_argument("--maxIteration", type=int, default=20)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--parameterMode", default="partitioned",
                   choices=["partitioned", "allreduce", "blockstore"])
    p.add_argument("--compress", default=None,
                   choices=[None, "bf16", "fp16"])
    p.add_argument("--dropPercentage", type=float, default=0.0)
    p.add_argument("--nSamples", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (NCCL) unless the CPU (gloo) is asked for")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (
        SGD, Optimizer, Top1Accuracy, TrainingPreempted, Trigger,
    )
    from bigdl_tpu_torch.utils.engine import Engine

    # a caller that started the group keeps it; else this main starts one
    # (a coordinator, torchrun's environment, or one process) and ends it
    started = not torch.distributed.is_initialized()
    if started:
        Engine.init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.nProcs if args.coordinator else None,
            process_id=args.procId if args.coordinator else None,
            device=args.device)
    try:
        rs = np.random.RandomState(0)
        samples = [Sample(rs.rand(1, 28, 28).astype(np.float32),
                          np.float32(i % 10 + 1))
                   for i in range(args.nSamples)]
        train_ds = DataSet.distributed(samples)
        val_ds = DataSet.distributed(
            [Sample(rs.rand(1, 28, 28).astype(np.float32),
                    np.float32(i % 10 + 1)) for i in range(128)])
        kw = {}
        if args.parameterMode != "blockstore":
            kw["mesh"] = Engine.mesh(("data",))
        model = LeNet5(10, device=args.device, generator=torch.Generator(
            device=args.device).manual_seed(42))
        opt = Optimizer(
            model=model, dataset=train_ds, criterion=ClassNLLCriterion(),
            batch_size=args.batchSize,
            end_trigger=Trigger.max_iteration(args.maxIteration),
            parameter_mode=args.parameterMode, compress=args.compress, **kw)
        opt.set_optim_method(SGD(learning_rate=args.learningRate,
                                 momentum=0.9))
        opt.set_validation(Trigger.several_iteration(10), val_ds,
                           [Top1Accuracy()], batch_size=args.batchSize)
        if args.dropPercentage > 0:
            opt.set_drop_module_property(args.dropPercentage)
        if args.checkpoint:
            # every rank may be given the same path: each writes and reads
            # its own <path>/proc_<rank>
            opt.set_checkpoint(args.checkpoint, Trigger.several_iteration(5))
            opt.handle_preemption()
        try:
            trained = opt.optimize(resume=args.resume)
        except TrainingPreempted as e:
            print(f"evicted cleanly: {e} — restart with --resume")
            return None
        n = sum(int(w.numel()) for w in trained.parameters())
        print(f"done: {n} parameters trained, last loss recorded in metrics")
        return trained
    finally:
        if started:           # the group this main started ends with it
            Engine.shutdown()


if __name__ == "__main__":
    main()
