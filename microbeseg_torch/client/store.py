"""Image-store abstraction: OMERO gateway or local filesystem.

The port's copy of ``microbeseg_tpu/client/store.py``: the same classes, the
same behaviour, and the same on-disk layout of a ``LocalStore``, so a store
written by one package opens in the other.  The reference talks to an OMERO
server through BlitzGateway's narrow surface (getPlane, polygon ROIs, map
annotations, file annotations; reference call sites e.g.
src/inference/infer.py:96-111, src/utils/data_export.py:38-42).  This module
defines that surface as an explicit ``ImageStore`` interface with two
implementations:

- ``OmeroStore``: wraps a live BlitzGateway connection (import-gated: it
  raises a clear error where omero-py is not installed);
- ``LocalStore``: filesystem-backed implementation of the same surface, used
  for offline operation and as the recorded-fixture fake in tests.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from microbeseg_torch.utils.tiff import imread_page, imwrite

# Guards lazy per-store RLock creation so two threads racing the first
# `store.lock` access cannot each mint a distinct lock.
_LOCK_CREATION_GUARD = threading.Lock()

ANALYSIS_NAMESPACE = "microbeseg.analysis.namespace"


@dataclass
class ImageRef:
    image_id: int
    name: str
    size_t: int
    size_c: int
    size_z: int
    size_y: int
    size_x: int
    dataset_id: int = -1


@dataclass
class RoiPolygon:
    """One polygon ROI: t/z plane plus an OMERO-style points string."""
    t: int
    z: int
    points: str


class ImageStore:
    """Interface — see LocalStore for the reference implementation."""

    @property
    def lock(self) -> "threading.RLock":
        """Serializes store access across threads.  One BlitzGateway/Ice
        connection is not thread-safe, so any worker that talks to the store
        from more than one thread (e.g. the pipelined ``infer_dataset``) must
        hold this lock around every store call.  Lazily created under a
        module-level guard so concurrent first accesses share one RLock."""
        lk = self.__dict__.get("_lock")
        if lk is None:
            with _LOCK_CREATION_GUARD:
                lk = self.__dict__.setdefault("_lock", threading.RLock())
        return lk

    def list_images(self, dataset_id: int) -> List[ImageRef]:
        raise NotImplementedError

    def get_image(self, image_id: int) -> ImageRef:
        raise NotImplementedError

    def get_plane(self, image_id: int, z: int, c: int, t: int) -> np.ndarray:
        raise NotImplementedError

    def upload_image(self, dataset_id: int, name: str,
                     stack: np.ndarray) -> int:
        """Upload a (Y,X), (T,Y,X) or (T,C,Y,X) grayscale stack."""
        raise NotImplementedError

    def get_map_annotation(self, image_id: int) -> Dict[str, str]:
        raise NotImplementedError

    def set_map_annotation(self, image_id: int, kv: Dict[str, str]) -> None:
        raise NotImplementedError

    def get_polygons(self, image_id: int) -> List[RoiPolygon]:
        raise NotImplementedError

    def add_polygons(self, image_id: int, polys: List[RoiPolygon]) -> None:
        raise NotImplementedError

    def delete_polygons(self, image_id: int) -> None:
        raise NotImplementedError

    def attach_file(self, image_id: int, path: Path,
                    namespace: str = "") -> None:
        raise NotImplementedError

    def list_attachments(self, image_id: int,
                         namespace: Optional[str] = None) -> List[str]:
        raise NotImplementedError

    def download_attachment(self, image_id: int, name: str,
                            target: Path) -> Optional[Path]:
        raise NotImplementedError

    def delete_attachments(self, image_id: int,
                           namespace: Optional[str] = None,
                           names: Optional[List[str]] = None) -> None:
        """Delete attachments in ``namespace`` and/or with filenames in
        ``names`` (union); both None deletes all."""
        raise NotImplementedError

    def can_annotate(self, image_id: int) -> bool:
        """Write permission on an image (reference infer.py:157)."""
        return True

    def create_dataset(self, name: str, project_id: int = -1) -> int:
        raise NotImplementedError

    # -- dataset-level annotations (the reference keeps per-trainset state
    # on the OMERO dataset: the crop_size map annotation,
    # microbe_seg_gui.py:1976-1981/2172-2185, and the split_info.json file
    # annotation, :2188-2206/2782-2796) ---------------------------------
    def get_dataset_map_annotation(self, dataset_id: int) -> Dict[str, str]:
        raise NotImplementedError

    def set_dataset_map_annotation(self, dataset_id: int,
                                   kv: Dict[str, str]) -> None:
        raise NotImplementedError

    def attach_dataset_file(self, dataset_id: int, path: Path,
                            namespace: str = "") -> None:
        raise NotImplementedError

    def list_dataset_attachments(self, dataset_id: int,
                                 namespace: Optional[str] = None) -> List[str]:
        raise NotImplementedError

    def download_dataset_attachment(self, dataset_id: int, name: str,
                                    target: Path) -> Optional[Path]:
        raise NotImplementedError

    def delete_dataset_attachments(self, dataset_id: int,
                                   namespace: Optional[str] = None) -> None:
        raise NotImplementedError

    def dataset_name(self, dataset_id: int) -> str:
        raise NotImplementedError

    def list_datasets(self, project_id: int) -> List[int]:
        """Dataset ids under a project (reference infer_script.py:81-85)."""
        raise NotImplementedError

    def list_projects(self) -> List[Tuple[int, str]]:
        """(project_id, name) pairs visible to the user (reference browses
        projects BY NAME in its selection dialogs, gui:1658-1797)."""
        raise NotImplementedError

    def image_group(self, image_id: int) -> int:
        """Permission-group id of an image; the store-backed inference CLI
        enforces single-group selections (reference infer_script.py:106-108)."""
        raise NotImplementedError

    def list_groups(self) -> List[Tuple[int, str]]:
        """(group_id, name) pairs the user is a member of (reference
        'Change group' menu, microbe_seg_gui.py:1309-1352)."""
        return [(0, "default")]

    def set_group(self, group_id: int) -> None:
        """Scope subsequent browsing to one permission group (reference
        gui:1352 sets group_id; OMERO: SERVICE_OPTS.setOmeroGroup)."""

    def close(self) -> None:
        pass


class LocalStore(ImageStore):
    """Filesystem-backed store.

    Layout: root/datasets/{id}/meta.json, root/images/{id}/
    {data.tif, meta.json, map.json, rois.json, attachments/}.
    """

    def __init__(self, root: Path):
        self.root = Path(root)
        (self.root / "datasets").mkdir(parents=True, exist_ok=True)
        (self.root / "images").mkdir(parents=True, exist_ok=True)

    # -- helpers -------------------------------------------------------
    def _next_id(self, kind: str) -> int:
        existing = [int(p.name) for p in (self.root / kind).iterdir()
                    if p.name.isdigit()]
        return (max(existing) + 1) if existing else 1

    def _img_dir(self, image_id: int) -> Path:
        d = self.root / "images" / str(image_id)
        if not d.is_dir():
            raise KeyError(f"image {image_id} not found")
        return d

    def _read_json(self, p: Path, default):
        return json.loads(p.read_text()) if p.is_file() else default

    # -- datasets ------------------------------------------------------
    def create_dataset(self, name: str, project_id: int = -1) -> int:
        did = self._next_id("datasets")
        d = self.root / "datasets" / str(did)
        d.mkdir()
        (d / "meta.json").write_text(
            json.dumps({"name": name, "project_id": project_id}))
        return did

    def dataset_name(self, dataset_id: int) -> str:
        meta = self._read_json(
            self.root / "datasets" / str(dataset_id) / "meta.json", {})
        return meta.get("name", str(dataset_id))

    def _ds_dir(self, dataset_id: int) -> Path:
        d = self.root / "datasets" / str(dataset_id)
        if not d.is_dir():
            raise KeyError(f"dataset {dataset_id} not found")
        return d

    def get_dataset_map_annotation(self, dataset_id: int) -> Dict[str, str]:
        return self._read_json(self._ds_dir(dataset_id) / "map.json", {})

    def set_dataset_map_annotation(self, dataset_id: int,
                                   kv: Dict[str, str]) -> None:
        d = self._ds_dir(dataset_id)
        cur = self._read_json(d / "map.json", {})
        cur.update({k: str(v) for k, v in kv.items()})
        (d / "map.json").write_text(json.dumps(cur))

    def attach_dataset_file(self, dataset_id: int, path: Path,
                            namespace: str = "") -> None:
        self._attach(self._ds_dir(dataset_id) / "attachments",
                     path, namespace)

    def list_dataset_attachments(self, dataset_id: int,
                                 namespace: Optional[str] = None) -> List[str]:
        return self._list_attach(self._ds_dir(dataset_id) / "attachments",
                                 namespace)

    def download_dataset_attachment(self, dataset_id: int, name: str,
                                    target: Path) -> Optional[Path]:
        return self._download_attach(
            self._ds_dir(dataset_id) / "attachments", name, target)

    def delete_dataset_attachments(self, dataset_id: int,
                                   namespace: Optional[str] = None) -> None:
        self._delete_attach(self._ds_dir(dataset_id) / "attachments",
                            namespace, None)

    def list_datasets(self, project_id: int) -> List[int]:
        out = []
        for p in sorted((self.root / "datasets").iterdir(),
                        key=lambda q: int(q.name) if q.name.isdigit() else 0):
            meta = self._read_json(p / "meta.json", {})
            if meta.get("project_id") == project_id:
                out.append(int(p.name))
        return out

    def create_project(self, name: str) -> int:
        (self.root / "projects").mkdir(exist_ok=True)
        pid = self._next_id("projects")
        d = self.root / "projects" / str(pid)
        d.mkdir()
        (d / "meta.json").write_text(json.dumps({"name": name}))
        return pid

    def list_projects(self) -> List[Tuple[int, str]]:
        out = {}
        proj_dir = self.root / "projects"
        if proj_dir.is_dir():
            for p in sorted(proj_dir.iterdir(),
                            key=lambda q: int(q.name) if q.name.isdigit() else 0):
                meta = self._read_json(p / "meta.json", {})
                out[int(p.name)] = meta.get("name", p.name)
        # projects referenced only by datasets (created elsewhere) still list
        for p in sorted((self.root / "datasets").iterdir(),
                        key=lambda q: int(q.name) if q.name.isdigit() else 0):
            meta = self._read_json(p / "meta.json", {})
            pid = meta.get("project_id", -1)
            if pid is not None and pid >= 0 and pid not in out:
                out[pid] = str(pid)
        return sorted(out.items())

    def image_group(self, image_id: int) -> int:
        meta = self._read_json(self._img_dir(image_id) / "meta.json", {})
        return int(meta.get("group", 0))

    def list_images(self, dataset_id: int) -> List[ImageRef]:
        out = []
        for p in sorted((self.root / "images").iterdir(),
                        key=lambda q: int(q.name) if q.name.isdigit() else 0):
            meta = self._read_json(p / "meta.json", {})
            if meta.get("dataset_id") == dataset_id:
                out.append(self.get_image(int(p.name)))
        return out

    # -- images --------------------------------------------------------
    def upload_image(self, dataset_id: int, name: str,
                     stack: np.ndarray) -> int:
        stack = np.asarray(stack)
        if stack.ndim == 2:
            stack = stack[None]
        if stack.ndim == 3:
            stack = stack[:, None]  # (T,Y,X) -> (T,1,Y,X)
        size_t, size_c = int(stack.shape[0]), int(stack.shape[1])
        iid = self._next_id("images")
        d = self.root / "images" / str(iid)
        (d / "attachments").mkdir(parents=True)
        # pages flattened t-major, c-minor: page = t*size_c + c
        imwrite(d / "data.tif", stack.reshape(-1, *stack.shape[2:]))
        meta = {"name": name, "dataset_id": dataset_id,
                "size_t": size_t, "size_c": size_c, "size_z": 1,
                "size_y": int(stack.shape[2]), "size_x": int(stack.shape[3])}
        (d / "meta.json").write_text(json.dumps(meta))
        return iid

    def get_image(self, image_id: int) -> ImageRef:
        meta = self._read_json(self._img_dir(image_id) / "meta.json", {})
        return ImageRef(image_id=image_id, name=meta.get("name", ""),
                        size_t=meta.get("size_t", 1),
                        size_c=meta.get("size_c", 1),
                        size_z=meta.get("size_z", 1),
                        size_y=meta.get("size_y", 0),
                        size_x=meta.get("size_x", 0),
                        dataset_id=meta.get("dataset_id", -1))

    def get_plane(self, image_id: int, z: int, c: int, t: int) -> np.ndarray:
        meta = self._read_json(self._img_dir(image_id) / "meta.json", {})
        size_c = int(meta.get("size_c", 1))
        if not 0 <= c < size_c:
            raise IndexError(f"channel {c} out of range (size_c={size_c})")
        # decode only the requested page — a stack-sized read per plane made
        # every plane-loop worker O(frames^2) in IO on 2D+t experiments
        return imread_page(self._img_dir(image_id) / "data.tif",
                           t * size_c + c)

    # -- map annotations ----------------------------------------------
    def get_map_annotation(self, image_id: int) -> Dict[str, str]:
        return self._read_json(self._img_dir(image_id) / "map.json", {})

    def set_map_annotation(self, image_id: int, kv: Dict[str, str]) -> None:
        d = self._img_dir(image_id)
        cur = self._read_json(d / "map.json", {})
        cur.update({k: str(v) for k, v in kv.items()})
        (d / "map.json").write_text(json.dumps(cur))

    # -- ROIs ----------------------------------------------------------
    def get_polygons(self, image_id: int) -> List[RoiPolygon]:
        raw = self._read_json(self._img_dir(image_id) / "rois.json", [])
        return [RoiPolygon(**r) for r in raw]

    def add_polygons(self, image_id: int, polys: List[RoiPolygon]) -> None:
        d = self._img_dir(image_id)
        cur = self._read_json(d / "rois.json", [])
        cur.extend({"t": p.t, "z": p.z, "points": p.points} for p in polys)
        (d / "rois.json").write_text(json.dumps(cur))

    def delete_polygons(self, image_id: int) -> None:
        p = self._img_dir(image_id) / "rois.json"
        if p.is_file():
            p.unlink()

    # -- attachments (shared helpers: image- and dataset-level attachments
    # use the same directory layout) -----------------------------------
    def _attach(self, d: Path, path: Path, namespace: str) -> None:
        d.mkdir(parents=True, exist_ok=True)
        target = d / Path(path).name
        target.write_bytes(Path(path).read_bytes())
        ns = self._read_json(d / "_namespaces.json", {})
        ns[Path(path).name] = namespace
        (d / "_namespaces.json").write_text(json.dumps(ns))

    def _list_attach(self, d: Path,
                     namespace: Optional[str]) -> List[str]:
        if not d.is_dir():
            return []
        ns = self._read_json(d / "_namespaces.json", {})
        out = []
        for f in sorted(d.iterdir()):
            if f.name.startswith("_"):
                continue
            if namespace is None or ns.get(f.name, "") == namespace:
                out.append(f.name)
        return out

    def _download_attach(self, d: Path, name: str,
                         target: Path) -> Optional[Path]:
        src = d / name
        if not src.is_file():
            return None
        target = Path(target)
        target.write_bytes(src.read_bytes())
        return target

    def _delete_attach(self, d: Path, namespace: Optional[str],
                       names: Optional[List[str]]) -> None:
        if not d.is_dir():
            return
        ns = self._read_json(d / "_namespaces.json", {})
        for f in list(d.iterdir()):
            if f.name.startswith("_"):
                continue
            hit = (namespace is None and names is None) \
                or (namespace is not None and ns.get(f.name, "") == namespace) \
                or (names is not None and f.name in names)
            if hit:
                f.unlink()
                ns.pop(f.name, None)
        (d / "_namespaces.json").write_text(json.dumps(ns))

    def attach_file(self, image_id: int, path: Path,
                    namespace: str = "") -> None:
        self._attach(self._img_dir(image_id) / "attachments", path, namespace)

    def list_attachments(self, image_id: int,
                         namespace: Optional[str] = None) -> List[str]:
        return self._list_attach(self._img_dir(image_id) / "attachments",
                                 namespace)

    def download_attachment(self, image_id: int, name: str,
                            target: Path) -> Optional[Path]:
        return self._download_attach(self._img_dir(image_id) / "attachments",
                                     name, target)

    def delete_attachments(self, image_id: int,
                           namespace: Optional[str] = None,
                           names: Optional[List[str]] = None) -> None:
        self._delete_attach(self._img_dir(image_id) / "attachments",
                            namespace, names)


def _with_reconnect(fn):
    """On any gateway error: disconnect, reconnect, retry the call once.

    The reference applies this pattern ad hoc at its OMERO call sites
    (src/inference/infer.py:138-143, src/inference/analysis.py:85-90,
    src/inference/result_export.py:83-88, src/utils/data_cropping.py:146-151);
    here it uniformly guards every store method.
    """
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except Exception:
            self._reconnect()
            return fn(self, *args, **kwargs)
    return wrapper


def _reconnect_reraise(fn):
    """On a gateway error: heal the connection, then RE-RAISE.

    For non-idempotent mutators (image/ROI/attachment uploads, dataset
    creation) a blind retry after a MID-CALL drop would duplicate whatever
    the server already persisted (e.g. thousands of ROIs saved before the
    drop).  The reconnect keeps subsequent store calls working; the caller
    decides whether repeating the mutation is safe."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except Exception:
            try:
                self._reconnect()
            except Exception:
                pass
            raise
    return wrapper


def omero_store_from_args(args) -> "OmeroStore":
    """Connected OmeroStore from CLI args + ``./settings.json``.

    One implementation of the reference's credential flow (settings file,
    username fallback prompt, getpass — train_script.py:35-49,
    infer_script.py:37-51) shared by every CLI."""
    import getpass

    settings_path = Path.cwd() / "settings.json"
    settings = (json.loads(settings_path.read_text())
                if settings_path.is_file() else {})
    username = (getattr(args, "username", None)
                or settings.get("omero_username")
                or input("OMERO username: "))
    password = (getattr(args, "password", None)
                or getpass.getpass(prompt="Password: "))
    host = getattr(args, "host", None) or settings.get("omero_host")
    port = int(getattr(args, "port", None) or settings.get("omero_port", 4064))
    return OmeroStore(username, password, host, port)


class OmeroStore(ImageStore):
    """BlitzGateway-backed store (requires omero-py; import-gated).

    Maps the full ``ImageStore`` surface onto BlitzGateway — the reference's
    call sites are cited per method.  All methods carry the reconnect-retry
    guard.  Tested against a fake in-memory gateway (tests/fake_omero.py);
    the real wire protocol stays in omero-py.
    """

    def __init__(self, username: str, password: str, host: str, port: int,
                 secure: bool = True):
        try:
            import omero  # type: ignore  # noqa: F401
            import omero.constants  # type: ignore  # noqa: F401
            import omero.gateway  # type: ignore  # noqa: F401
            import omero.model  # type: ignore  # noqa: F401
            import omero.rtypes  # type: ignore  # noqa: F401
        except ImportError as exc:  # pragma: no cover - without omero-py
            raise ImportError(
                "omero-py is not installed; use LocalStore for offline "
                "operation or install omero-py for server-backed workflows"
            ) from exc
        self._omero = omero
        self._login = (username, password, host, port, secure)
        self._conn = None
        self._connect()

    # -- connection lifecycle -------------------------------------------
    def _connect(self) -> None:
        username, password, host, port, secure = self._login
        conn = self._omero.gateway.BlitzGateway(
            username, password, host=host, port=port, secure=secure)
        if not conn.connect():
            raise ConnectionError("No OMERO connection possible. "
                                  "Check inputs or connection.")
        # "-1" = all groups (reference infer_script.py:77); a reconnect
        # must re-apply the user-selected group or set_group() would be
        # silently undone by any transient gateway error
        conn.SERVICE_OPTS.setOmeroGroup(str(getattr(self, "_group", -1)))
        self._conn = conn

    def _reconnect(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass
        self._connect()

    def close(self) -> None:
        self._conn.close()

    # -- helpers ---------------------------------------------------------
    def _image(self, image_id: int):
        img = self._conn.getObject("Image", image_id)
        if img is None:
            raise KeyError(f"image {image_id} not found")
        return img

    def _to_ref(self, img, dataset_id: int = -1) -> ImageRef:
        return ImageRef(
            image_id=int(img.getId()), name=img.getName(),
            size_t=int(img.getSizeT()), size_c=int(img.getSizeC()),
            size_z=int(img.getSizeZ()), size_y=int(img.getSizeY()),
            size_x=int(img.getSizeX()), dataset_id=dataset_id)

    def _file_anns(self, image_id: int, namespace: Optional[str]):
        wrapper = self._omero.gateway.FileAnnotationWrapper
        for ann in self._image(image_id).listAnnotations():
            if isinstance(ann, wrapper):
                if namespace is None or ann.getNs() == namespace:
                    yield ann

    # -- datasets / projects ----------------------------------------------
    @_reconnect_reraise
    def create_dataset(self, name: str, project_id: int = -1) -> int:
        # reference microbe_seg_gui.py:1929-1987 (trainset creation)
        ds = self._omero.model.DatasetI()
        ds.setName(self._omero.rtypes.rstring(name))
        ds = self._conn.getUpdateService().saveAndReturnObject(ds)
        did = int(ds.getId().getValue())
        if project_id >= 0:
            link = self._omero.model.ProjectDatasetLinkI()
            link.setParent(self._omero.model.ProjectI(project_id, False))
            link.setChild(self._omero.model.DatasetI(did, False))
            self._conn.getUpdateService().saveAndReturnObject(link)
        return did

    @_with_reconnect
    def dataset_name(self, dataset_id: int) -> str:
        ds = self._conn.getObject("Dataset", dataset_id)
        if ds is None:
            raise KeyError(f"dataset {dataset_id} not found")
        return ds.getName()

    @_with_reconnect
    def list_datasets(self, project_id: int) -> List[int]:
        # reference infer_script.py:81-85 (project -> dataset expansion)
        project = self._conn.getObject("Project", project_id)
        if project is None:
            raise KeyError(f"project {project_id} not found")
        return [int(ds.getId()) for ds in project.listChildren()]

    @_with_reconnect
    def list_projects(self) -> List[Tuple[int, str]]:
        # reference project-selection dialogs browse by name (gui:1658-1797)
        return sorted((int(p.getId()), str(p.getName()))
                      for p in self._conn.getObjects("Project"))

    def _dataset(self, dataset_id: int):
        ds = self._conn.getObject("Dataset", dataset_id)
        if ds is None:
            raise KeyError(f"dataset {dataset_id} not found")
        return ds

    @_with_reconnect
    def get_dataset_map_annotation(self, dataset_id: int) -> Dict[str, str]:
        # reference microbe_seg_gui.py:2172-2185 (crop_size read-back)
        wrapper = self._omero.gateway.MapAnnotationWrapper
        out: Dict[str, str] = {}
        for ann in self._dataset(dataset_id).listAnnotations():
            if isinstance(ann, wrapper):
                out.update({str(k): str(v) for k, v in ann.getValue()})
        return out

    @_with_reconnect
    def set_dataset_map_annotation(self, dataset_id: int,
                                   kv: Dict[str, str]) -> None:
        # reference microbe_seg_gui.py:1976-1981 (crop_size on the trainset;
        # client namespace so OMERO.web/Insight can edit it); merge-replace
        # like set_map_annotation
        ds = self._dataset(dataset_id)
        wrapper = self._omero.gateway.MapAnnotationWrapper
        merged: Dict[str, str] = {}
        stale = []
        for ann in ds.listAnnotations():
            if isinstance(ann, wrapper):
                merged.update({str(k): str(v) for k, v in ann.getValue()})
                if ann.canEdit():
                    stale.append(ann.getId())
        merged.update({str(k): str(v) for k, v in kv.items()})
        ann = wrapper(self._conn)
        ann.setNs(self._omero.constants.metadata.NSCLIENTMAPANNOTATION)
        ann.setValue([[k, v] for k, v in merged.items()])
        ann.save()
        ds.linkAnnotation(ann)
        if stale:
            self._conn.deleteObjects("Annotation", stale, wait=True)

    def _ds_file_anns(self, dataset_id: int, namespace: Optional[str]):
        wrapper = self._omero.gateway.FileAnnotationWrapper
        for ann in self._dataset(dataset_id).listAnnotations():
            if isinstance(ann, wrapper):
                if namespace is None or ann.getNs() == namespace:
                    yield ann

    @_reconnect_reraise
    def attach_dataset_file(self, dataset_id: int, path: Path,
                            namespace: str = "") -> None:
        # reference microbe_seg_gui.py:2782-2796 (split_info.json re-upload)
        ds = self._dataset(dataset_id)
        ann = self._conn.createFileAnnfromLocalFile(
            str(path), mimetype="application/json", ns=namespace or None)
        ds.linkAnnotation(ann)

    @_with_reconnect
    def list_dataset_attachments(self, dataset_id: int,
                                 namespace: Optional[str] = None) -> List[str]:
        return [ann.getFileName()
                for ann in self._ds_file_anns(dataset_id, namespace)]

    @_with_reconnect
    def download_dataset_attachment(self, dataset_id: int, name: str,
                                    target: Path) -> Optional[Path]:
        # reference microbe_seg_gui.py:2188-2200 (split_info.json download)
        for ann in self._ds_file_anns(dataset_id, None):
            if ann.getFileName() == name:
                target = Path(target)
                with open(target, "wb") as fh:
                    for chunk in ann.getFileInChunks():
                        fh.write(chunk)
                return target
        return None

    @_with_reconnect
    def delete_dataset_attachments(self, dataset_id: int,
                                   namespace: Optional[str] = None) -> None:
        # reference microbe_seg_gui.py:2789-2793 (stale split_info eviction)
        ids = [ann.getId()
               for ann in self._ds_file_anns(dataset_id, namespace)]
        if ids:
            self._conn.deleteObjects("Annotation", ids, wait=True)

    @_with_reconnect
    def image_group(self, image_id: int) -> int:
        # reference infer_script.py:85 (getDetails().group.id.val)
        return int(self._image(image_id).getDetails().group.id.val)

    @_with_reconnect
    def list_groups(self) -> List[Tuple[int, str]]:
        # reference 'Change group' menu (microbe_seg_gui.py:1320-1324:
        # conn.getGroupsMemberOf), sorted by name like the reference
        groups = [(int(g.getId()), str(g.getName()))
                  for g in self._conn.getGroupsMemberOf()]
        return sorted(groups, key=lambda g: g[1].lower())

    def set_group(self, group_id: int) -> None:
        # scope browsing to one group (reference gui:1352; -1 = all groups)
        self._group = int(group_id)
        self._conn.SERVICE_OPTS.setOmeroGroup(str(int(group_id)))

    # -- images ------------------------------------------------------------
    @_with_reconnect
    def list_images(self, dataset_id: int) -> List[ImageRef]:
        ds = self._conn.getObject("Dataset", dataset_id)
        if ds is None:
            raise KeyError(f"dataset {dataset_id} not found")
        return [self._to_ref(img, dataset_id) for img in ds.listChildren()]

    @_with_reconnect
    def get_image(self, image_id: int) -> ImageRef:
        img = self._image(image_id)
        parent = img.getParent()
        return self._to_ref(img, int(parent.getId()) if parent else -1)

    @_with_reconnect
    def get_plane(self, image_id: int, z: int, c: int, t: int) -> np.ndarray:
        # reference src/inference/infer.py:250 (getPrimaryPixels().getPlane)
        pixels = self._image(image_id).getPrimaryPixels()
        return np.asarray(pixels.getPlane(z, c, t))

    @_reconnect_reraise
    def upload_image(self, dataset_id: int, name: str,
                     stack: np.ndarray) -> int:
        # reference src/utils/data_import.py:197-230 / gui:2725-2740
        # (createImageFromNumpySeq)
        stack = np.asarray(stack)
        if stack.ndim == 2:
            stack = stack[None]
        if stack.ndim == 3:
            stack = stack[:, None]  # (T,Y,X) -> (T,1,Y,X)
        size_t, size_c = int(stack.shape[0]), int(stack.shape[1])
        ds = self._conn.getObject("Dataset", dataset_id)

        def planes():
            # createImageFromNumpySeq consumes z-major, then c, then t
            for c in range(size_c):
                for t in range(size_t):
                    yield stack[t, c]

        img = self._conn.createImageFromNumpySeq(
            planes(), name, sizeZ=1, sizeC=size_c, sizeT=size_t, dataset=ds)
        return int(img.getId())

    # -- map annotations ----------------------------------------------------
    @_with_reconnect
    def get_map_annotation(self, image_id: int) -> Dict[str, str]:
        # reference src/utils/data_export.py:76-91
        wrapper = self._omero.gateway.MapAnnotationWrapper
        out: Dict[str, str] = {}
        for ann in self._image(image_id).listAnnotations():
            if isinstance(ann, wrapper):
                out.update({str(k): str(v) for k, v in ann.getValue()})
        return out

    @_with_reconnect
    def set_map_annotation(self, image_id: int, kv: Dict[str, str]) -> None:
        # reference src/inference/infer.py:294-315: merge keys, replace the
        # editable annotation, keep the client namespace so OMERO.web/Insight
        # can edit it
        img = self._image(image_id)
        wrapper = self._omero.gateway.MapAnnotationWrapper
        merged: Dict[str, str] = {}
        stale = []
        for ann in img.listAnnotations():
            if isinstance(ann, wrapper):
                merged.update({str(k): str(v) for k, v in ann.getValue()})
                if ann.canEdit():
                    stale.append(ann.getId())
        merged.update({str(k): str(v) for k, v in kv.items()})
        # save-and-link the merged annotation BEFORE deleting the stale
        # ones: if the connection drops mid-call, the reconnect retry then
        # re-reads a state that still contains every key (delete-first would
        # lose all pre-existing metadata on retry)
        ann = wrapper(self._conn)
        ann.setNs(self._omero.constants.metadata.NSCLIENTMAPANNOTATION)
        ann.setValue([[k, v] for k, v in merged.items()])
        ann.save()
        img.linkAnnotation(ann)
        if stale:
            self._conn.deleteObjects("Annotation", stale, wait=True)

    # -- polygon ROIs ---------------------------------------------------------
    @_with_reconnect
    def get_polygons(self, image_id: int) -> List[RoiPolygon]:
        # reference src/utils/data_export.py:60-70 (ROI service)
        result = self._conn.getRoiService().findByImage(image_id, None)
        out = []
        for roi in result.rois:
            for shape in roi.copyShapes():
                if isinstance(shape, self._omero.model.PolygonI):
                    t = shape.getTheT()
                    z = shape.getTheZ()
                    out.append(RoiPolygon(
                        t=int(t.getValue()) if t is not None else 0,
                        z=int(z.getValue()) if z is not None else 0,
                        points=shape.getPoints().getValue()))
        return out

    @_reconnect_reraise
    def add_polygons(self, image_id: int, polys: List[RoiPolygon]) -> None:
        # reference src/utils/data_import.py:289-305 (create_roi)
        update = self._conn.getUpdateService()
        img = self._image(image_id)
        rtypes = self._omero.rtypes
        for p in polys:
            shape = self._omero.model.PolygonI()
            shape.theT = rtypes.rint(p.t)
            shape.theZ = rtypes.rint(p.z)
            shape.points = rtypes.rstring(p.points)
            roi = self._omero.model.RoiI()
            roi.setImage(img._obj)
            roi.addShape(shape)
            update.saveAndReturnObject(roi)

    @_with_reconnect
    def delete_polygons(self, image_id: int) -> None:
        # reference src/inference/infer.py:186-196
        result = self._conn.getRoiService().findByImage(image_id, None)
        roi_ids = [roi.id.val for roi in result.rois]
        if roi_ids:
            self._conn.deleteObjects("Roi", roi_ids, wait=True)

    # -- file attachments -----------------------------------------------------
    @_reconnect_reraise
    def attach_file(self, image_id: int, path: Path,
                    namespace: str = "") -> None:
        # reference src/inference/analysis.py:181-194
        img = self._image(image_id)
        ann = self._conn.createFileAnnfromLocalFile(
            str(path), mimetype="text/plain", ns=namespace or None)
        img.linkAnnotation(ann)

    @_with_reconnect
    def list_attachments(self, image_id: int,
                         namespace: Optional[str] = None) -> List[str]:
        return [ann.getFileName()
                for ann in self._file_anns(image_id, namespace)]

    @_with_reconnect
    def download_attachment(self, image_id: int, name: str,
                            target: Path) -> Optional[Path]:
        # reference src/inference/result_export.py:207-210 (getFileInChunks)
        for ann in self._file_anns(image_id, None):
            if ann.getFileName() == name:
                target = Path(target)
                with open(target, "wb") as fh:
                    for chunk in ann.getFileInChunks():
                        fh.write(chunk)
                return target
        return None

    @_with_reconnect
    def delete_attachments(self, image_id: int,
                           namespace: Optional[str] = None,
                           names: Optional[List[str]] = None) -> None:
        # reference src/inference/infer.py:197-205 (namespace- and
        # filename-matched attachment deletion on overwrite)
        ids = []
        for ann in self._file_anns(image_id, None):
            hit = (namespace is None and names is None) \
                or (namespace is not None and ann.getNs() == namespace) \
                or (names is not None and ann.getFileName() in names)
            if hit:
                ids.append(ann.getId())
        if ids:
            self._conn.deleteObjects("Annotation", ids, wait=True)

    @_with_reconnect
    def can_annotate(self, image_id: int) -> bool:
        # reference src/inference/infer.py:157 (canAnnotate)
        return bool(self._image(image_id).canAnnotate())


def timestamp() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")
