"""Store-backed (OMERO) inference CLI on the port (reference:
infer_script.py:13-129).

Same parser and id expansion as ``microbeseg_tpu/cli/infer_store.py``, plus
``--device`` (default: the CUDA card; ``--device cpu`` runs on the CPU).
Expands project/dataset/file ids to an image list and runs ``infer_dataset``
— uploading polygon ROIs + model/date annotations back to the store, or
writing local TIFFs.  Works against a live OMERO server (omero-py) or a
``LocalStore`` directory via ``--local_store``:

    python -m microbeseg_torch.cli.infer_store --local_store <root> \
        --dataset 1 -m <model stem>
"""

from __future__ import annotations

import argparse
from pathlib import Path

from microbeseg_torch.client.workers import infer_dataset
from microbeseg_torch.config import InferConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="microbeSEG OMERO inference (PyTorch/CUDA)")
    parser.add_argument("--project", default=[], type=int, nargs="+",
                        help="Project ids (expanded to all images; "
                             "reference infer_script.py:79-85)")
    parser.add_argument("--dataset", default=None, type=int, help="Dataset id")
    parser.add_argument("--files", default=[], type=int, nargs="+",
                        help="Image ids")
    # reference drop-in interface (infer_script.py:16-18): ids + a type
    # switch, mapped onto --project/--dataset/--files
    parser.add_argument("--omero_ids", "-ids", default=[], type=int,
                        nargs="+",
                        help="Reference-style id list; combine with "
                             "--id_type project|dataset|file")
    parser.add_argument("--id_type", default=None, type=str,
                        choices=("project", "dataset", "file"),
                        help='Meaning of --omero_ids (reference "-i")')
    parser.add_argument("--model", "-m", required=True, type=str, nargs="+",
                        help="Path to model; several paths form an ensemble "
                        "(averaged predictions, beyond reference)")
    parser.add_argument("--thresholds", "-t", default=[0.10, 0.45], type=float,
                        nargs="+", help="th_cell th_seed")
    parser.add_argument("--channel", "-c", default=0, type=int)
    parser.add_argument("--upload", default=True, action="store_true",
                        help="Upload ROIs back to the store")
    parser.add_argument("--no-upload", dest="upload", action="store_false")
    parser.add_argument("--overwrite", "-o", default=False, action="store_true")
    parser.add_argument("--result_path", "-r", default=None, type=str)
    parser.add_argument("--sliding_window", default=False, action="store_true",
                        help="Sliding-window tiled inference for large frames")
    parser.add_argument("--quantize", default=False, action="store_true",
                        help="int8 forward on the large-spatial conv layers "
                        "(beyond-reference serving mode, same checkpoints)")
    parser.add_argument("--tta", default=False, action="store_true",
                        help="Test-time augmentation: average predictions "
                        "over the dihedral transforms (beyond reference; "
                        "4-8x forward cost)")
    parser.add_argument("--local_store", default=None, type=str,
                        help="Path of a LocalStore root (offline mode)")
    parser.add_argument("--username", default=None, type=str)
    parser.add_argument("--password", default=None, type=str)
    parser.add_argument("--host", default=None, type=str)
    parser.add_argument("--port", default=None, type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.thresholds) != 2:
        raise ValueError("exactly 2 thresholds required (th_cell th_seed)")
    extra_datasets = []
    if args.omero_ids:
        if args.id_type is None:
            raise ValueError("--omero_ids requires --id_type "
                             "project|dataset|file")
        if args.id_type == "project":
            args.project = list(args.project) + list(args.omero_ids)
        elif args.id_type == "dataset":
            extra_datasets = list(args.omero_ids)
        else:
            args.files = list(args.files) + list(args.omero_ids)
    args._extra_datasets = extra_datasets

    # model files checked BEFORE any credential prompt / server connection
    # (a typo'd --model must not cost a login round-trip)
    from microbeseg_torch.cli.infer_local import resolve_model_stems
    stems = resolve_model_stems(args.model)

    if args.local_store:
        from microbeseg_torch.client.store import LocalStore
        store = LocalStore(Path(args.local_store))
    else:
        from microbeseg_torch.client.store import omero_store_from_args
        store = omero_store_from_args(args)

    try:
        return _run(args, store, stems)
    finally:
        store.close()


def _run(args, store, stems) -> int:
    extra_datasets = args._extra_datasets
    # Expand project -> datasets -> images (reference infer_script.py:79-108)
    image_ids = list(args.files)
    probe_ids = list(args.files)  # group probes: explicit files +
    dataset_ids = [] if args.dataset is None else [args.dataset]
    dataset_ids.extend(extra_datasets)
    for pid in args.project:
        dataset_ids.extend(store.list_datasets(pid))
    for did in dataset_ids:
        expanded = [ref.image_id for ref in store.list_images(did)]
        image_ids.extend(expanded)
        if expanded:
            probe_ids.append(expanded[0])  # one per dataset (images of a
            #                                dataset share its group)
    if not image_ids:
        print("No files found")
        return 0

    # Group-consistency check (reference infer_script.py:106-108 probes
    # every image; one probe per container is equivalent and avoids a
    # server round-trip per image)
    groups = {store.image_group(iid) for iid in probe_ids}
    if len(groups) > 1:
        raise ValueError(
            "Select only projects, datasets, and files from the same group!")

    cfg = InferConfig(th_cell=args.thresholds[0], th_seed=args.thresholds[1],
                      use_tiling=args.sliding_window, quantize=args.quantize,
                      tta=args.tta)
    from microbeseg_torch.cli.infer_local import build_engine
    engine = build_engine(stems, cfg, device=args.device)
    # the store's inference_model annotation names every ensemble member
    model_name = "+".join(s.name for s in stems)
    infer_dataset(store, image_ids, engine, model_name=model_name,
                  upload=args.upload, overwrite=args.overwrite,
                  result_dir=Path(args.result_path) if args.result_path else None,
                  channel=args.channel,
                  text_output=print)
    print("--- Finished ---")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
