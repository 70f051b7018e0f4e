"""Training CLI.

Port of wekws_tpu/bin/train.py (the reference wekws's bin/train.py):
YAML config + flags, per-epoch checkpoints ``<epoch>.pt`` with
{epoch, lr, cv_loss} sidecars, the resolved config at
``<model_dir>/config.yaml`` (with an absolute cmvn path) for scoring,
``init.pt``, ``metrics.jsonl``, TensorBoard epoch scalars under
``tensorboard/`` and a ``final.pt`` link.  One process a card
(``--device``, CUDA unless ``cpu`` is asked for): the host pipeline's
``DataLoader`` feeds the ``Trainer``, which runs the fused exact-BN
passes and the fused fbank as the config asks.  ``--device_resident``
stages both lists on the device once instead (``data/resident.py``,
before the model is built) and trains every epoch from there; for a
config with waveform augmentation (speed_perturb, noise, reverb) the
train pipeline then gets a ``DeviceWaveAug`` (``data/device_aug.py``)
with the noise and RIR banks staged on the card, and each step augments
its rows there.
``--checkpoint`` resumes from a port ``.pt`` or a JAX-package
``.ckpt``.  ``--dict`` (a CTC model: ``dict.txt``, and ``words.txt``
where present) tokenizes both data lists and sets the output width to
the vocabulary.

Data parallelism: every process runs this script with ``--coordinator
host:port --num_processes W --process_id r`` (rank 0 listens at the
coordinator; ``parallel/mesh.distributed_init``).  Rank r trains on
``cuda:{r % device_count}`` (or the CPU with ``--device cpu``), reads
its shard of the lists, and the ranks take one step on the global batch
(``train/steps.py``); its host-fed batch size is per process, its
resident one global, as in the JAX package.  Host-fed ranks need
``batch_conf.bucket_boundaries``: the bucket schedule, which every rank
computes from the whole list, keeps their batch shapes and counts in
lockstep, and a rank that ran out of batches first would hang its peers
in a collective (``fixed_samples`` fixes the frames but not the rows or
the count of batches a shard gives).  Only rank 0 writes the
config, the checkpoints, TensorBoard and the metrics file, and logs the
epoch line; every rank logs the same cv figures.

Torch is imported inside ``main``, so the loader's spawned workers,
which import this module as their main module, start without it.
"""

import argparse
import logging
import os
import random

import numpy as np
import yaml


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="training your network")
    parser.add_argument("--config", required=True, help="config file")
    parser.add_argument("--train_data", required=True, help="train data list")
    parser.add_argument("--cv_data", required=True, help="cv data list")
    parser.add_argument("--model_dir", required=True, help="save model dir")
    parser.add_argument("--checkpoint",
                        help="checkpoint to resume from (.pt, or a JAX "
                             "package .ckpt)")
    parser.add_argument("--num_keywords", default=1, type=int,
                        help="number of keywords (output dim)")
    parser.add_argument("--min_duration", default=50, type=int,
                        help="min duration frames of the keyword")
    parser.add_argument("--seed", default=777, type=int, help="random seed")
    parser.add_argument("--cmvn_file", default=None, help="global cmvn file")
    parser.add_argument("--norm_var", action="store_true", default=False,
                        help="norm var option")
    parser.add_argument("--dict", dest="dict_dir", default=None,
                        help="dict dir for CTC (dict.txt, words.txt)")
    parser.add_argument("--num_epochs", type=int, default=None,
                        help="override training_config.max_epoch")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0, for training over "
                             "--num_processes processes")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of early steps")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="data-loading worker processes")
    parser.add_argument("--device_resident", action="store_true",
                        default=False,
                        help="stage the train and cv waves on the device "
                             "once (int16) and gather every batch there: no "
                             "wave crosses from the host during an epoch; "
                             "waveform augmentation (speed_perturb, noise, "
                             "reverb) runs on the device, in the step")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def rank_device(args):
    """This process's device: ``cuda:{process_id % device_count}`` for
    a CUDA rank of several, else ``--device``."""
    import torch

    from wekws_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if (device.type == "cuda" and device.index is None
            and (args.num_processes or 1) > 1):
        device = torch.device(
            "cuda", (args.process_id or 0) % torch.cuda.device_count())
    return device


def check_lockstep(dataset_conf: dict, world: int) -> None:
    """Host-fed ranks must agree on every batch's shape and on their
    batch count: the bucket schedule guarantees both."""
    bc = dataset_conf.get("batch_conf", {})
    if world > 1 and not bc.get("bucket_boundaries"):
        raise ValueError(
            "training over several processes from the host pipeline "
            "needs batch_conf.bucket_boundaries: every rank must take "
            "batches of one shape in lockstep (or pass "
            "--device_resident)")


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    from wekws_tpu_torch.parallel.mesh import (
        distributed_close,
        distributed_init,
        process_count,
        process_index,
    )

    device = rank_device(args)
    distributed_init(args.coordinator, args.num_processes, args.process_id,
                     device)
    try:
        return _train(args, device, process_index(), process_count())
    finally:
        distributed_close()


def _train(args, device, rank: int, world: int):
    import torch

    from wekws_tpu_torch.data import DeviceFeaturePipeline, init_dataset
    from wekws_tpu_torch.data.loader import DataLoader
    from wekws_tpu_torch.data.resident import stage_data_list, wants_wave_aug
    from wekws_tpu_torch.models import init_model
    from wekws_tpu_torch.parallel.mesh import fold_rank
    from wekws_tpu_torch.text import CharTokenizer
    from wekws_tpu_torch.train import (
        Executor,
        ReduceLROnPlateau,
        Trainer,
        link_final,
        load_checkpoint_info,
        save_checkpoint,
    )
    from wekws_tpu_torch.train.checkpoint import load_model_state
    from wekws_tpu_torch.train.tensorboard import SummaryWriter

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    with open(args.config, "r") as fin:
        configs = yaml.safe_load(fin)
    dataset_conf = configs["dataset_conf"]
    train_conf = configs.get("training_config", {})
    criterion_type = train_conf.get("criterion", None)

    tokenizer = None
    if args.dict_dir is not None:
        words = os.path.join(args.dict_dir, "words.txt")
        tokenizer = CharTokenizer(
            os.path.join(args.dict_dir, "dict.txt"),
            words if os.path.exists(words) else None,
            unk="<filler>",
        )

    train_pipeline = DeviceFeaturePipeline.from_conf(dataset_conf, True)
    cv_pipeline = DeviceFeaturePipeline.from_conf(dataset_conf, False)
    batch_size = dataset_conf.get("batch_conf", {}).get("batch_size", 16)
    train_corpus = cv_corpus = None
    if not args.device_resident:
        check_lockstep(dataset_conf, world)
    if args.device_resident:
        # staged before the model is built, as the JAX CLI does
        augment = wants_wave_aug(dataset_conf)
        train_corpus = stage_data_list(args.train_data, dataset_conf,
                                       tokenizer, split="train",
                                       device=device, device_aug=augment)
        cv_corpus = stage_data_list(args.cv_data, dataset_conf, tokenizer,
                                    split="cv", device=device)
        if augment:
            # the banks staged on the card once; speed, reverb and noise
            # run on each step's rows (the cv pipeline gets none)
            from wekws_tpu_torch.data.device_aug import DeviceWaveAug

            train_pipeline.wave_aug = DeviceWaveAug.from_conf(
                dataset_conf,
                max_wave_samples=int(train_corpus.arrays["waves"].shape[1]),
                device=device)

    # resolve the model config (reference train.py)
    model_conf = configs["model"]
    model_conf["input_dim"] = train_pipeline.output_dim
    if criterion_type == "ctc":
        if tokenizer is None:
            raise ValueError("criterion ctc needs --dict")
        model_conf["output_dim"] = tokenizer.vocab_size
    else:
        model_conf["output_dim"] = args.num_keywords
    if args.cmvn_file is not None:
        model_conf["cmvn"] = {
            # absolute: the resolved config is consumed from other cwds
            "cmvn_file": os.path.abspath(args.cmvn_file),
            "norm_var": args.norm_var,
        }
    if criterion_type is None:
        criterion_type = (
            "ce" if "classifier" in model_conf else "max_pooling"
        )
    configs["model"] = model_conf

    lead = rank == 0  # the one rank that writes files
    os.makedirs(args.model_dir, exist_ok=True)
    if lead:
        with open(os.path.join(args.model_dir, "config.yaml"), "w") as fout:
            yaml.dump(configs, fout)

    model = init_model(model_conf, torch.Generator().manual_seed(args.seed))
    # dropout draws from the global generator: each rank its own masks
    torch.manual_seed(fold_rank(args.seed, rank))
    start_epoch = 0
    optim_conf = configs.get("optim_conf", {})
    scheduler = ReduceLROnPlateau(optim_conf.get("lr", 1e-3))
    if args.checkpoint is not None:
        model.load_state_dict(load_model_state(args.checkpoint, model_conf,
                                               model))
        info = load_checkpoint_info(args.checkpoint)
        start_epoch = int(info.get("epoch", -1)) + 1
        if "lr" in info:
            scheduler.lr = float(info["lr"])
        if "cv_loss" in info:
            scheduler.best = float(info["cv_loss"])
        logging.info("resumed from %s at epoch %d", args.checkpoint,
                     start_epoch)
    elif lead:
        save_checkpoint(os.path.join(args.model_dir, "init.pt"),
                        model.state_dict())

    trainer = Trainer(
        model,
        train_pipeline,
        cv_pipeline,
        criterion_type,
        grad_clip=train_conf.get("grad_clip", 5.0),
        weight_decay=optim_conf.get("weight_decay", 0.0),
        min_duration=args.min_duration,
        device=device,
    )
    executor = Executor(
        trainer,
        log_interval=train_conf.get("log_interval", 10),
        metrics_path=(os.path.join(args.model_dir, "metrics.jsonl")
                      if lead else None),
        profile_dir=args.profile_dir,
    )
    state = trainer.init_state()
    max_epoch = args.num_epochs or train_conf.get("max_epoch", 100)
    train_dataset = cv_dataset = None
    if not args.device_resident:
        train_dataset = DataLoader(
            init_dataset(args.train_data, dataset_conf, tokenizer,
                         split="train", rank=rank, world_size=world),
            num_workers=args.num_workers,
        )
        cv_dataset = DataLoader(
            init_dataset(args.cv_data, dataset_conf, tokenizer, split="cv",
                         rank=rank, world_size=world),
            num_workers=args.num_workers,
        )
    # TensorBoard epoch scalars (reference train.py), beside metrics.jsonl
    writer = (SummaryWriter(os.path.join(args.model_dir, "tensorboard"))
              if lead else None)
    final_epoch = None
    try:
        for epoch in range(start_epoch, max_epoch):
            if args.device_resident:
                state, summary = executor.train_resident(
                    state, train_corpus, args.seed + 1, scheduler.lr, epoch,
                    batch_size)
                cv = executor.cv_resident(state, cv_corpus, batch_size,
                                          epoch)
            else:
                train_dataset.set_epoch(epoch)
                state, summary = executor.train(
                    state, train_dataset, args.seed + 1, scheduler.lr, epoch
                )
                cv = executor.cv(state, cv_dataset, epoch)
            if lead:
                logging.info(
                    "Epoch %d done: train_loss %.6f cv_loss %.6f cv_acc "
                    "%.4f throughput %.1f audio-s/s",
                    epoch, summary["train_loss"], cv["cv_loss"],
                    cv["cv_acc"], summary["audio_seconds_per_s"],
                )
                save_checkpoint(
                    os.path.join(args.model_dir, f"{epoch}.pt"),
                    state.model.state_dict(),
                    {"epoch": epoch, "lr": scheduler.lr,
                     "cv_loss": cv["cv_loss"]},
                )
                writer.add_scalars(
                    {"cv_loss": cv["cv_loss"], "cv_acc": cv["cv_acc"],
                     "lr": scheduler.lr,
                     "train_loss": summary["train_loss"]},
                    step=epoch,
                )
                writer.flush()
            scheduler.step(cv["cv_loss"])
            final_epoch = epoch
    finally:
        if writer is not None:
            writer.close()
        for loader in (train_dataset, cv_dataset):
            if loader is not None:
                loader.close()

    if final_epoch is not None and lead:
        link_final(args.model_dir, final_epoch)
    return state


if __name__ == "__main__":
    main()
