"""The port's ``cli/prepare_data.py`` (a copy) against the JAX package's: the
same commands on two copies of one seeded COCO tree (a missing image, an
orphan annotation, a degenerate box, a bad polygon, 3-digit Roboflow class
ids) print the same lines, return the same codes and leave byte-equal trees,
for every subcommand: scaffold, validate, fix-roboflow (twice: the second
finds the ids sequential), split."""

import filecmp
import json
import os
import shutil

import pytest

from sam3_lora_tpu.cli import prepare_data as jprep
from sam3_lora_tpu_torch.cli import prepare_data as tprep


def _tree(root):
    os.makedirs(root / "train")
    images = [{"id": i, "file_name": f"img{i}.jpg", "height": 8, "width": 8} for i in range(10)]
    for im in images[:-1]:  # the last image's file is missing
        (root / "train" / im["file_name"]).write_bytes(bytes([im["id"]]) * 16)
    anns = [{"id": i, "image_id": i % 10, "category_id": 101 + i % 3, "bbox": [1, 1, 4, 3],
             "segmentation": [[1, 1, 5, 1, 5, 4]]} for i in range(14)]
    anns[3]["bbox"] = [1, 1, 0, 3]                # degenerate
    anns[4]["segmentation"] = [[1, 1, 5]]          # bad polygon
    anns[5]["image_id"] = 99                       # orphan
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": f"c{c}"} for c in (103, 101, 102)]}
    (root / "train" / "_annotations.coco.json").write_text(json.dumps(coco))


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files or cmp.funny_files), \
        (cmp.left_only, cmp.right_only, cmp.diff_files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


@pytest.fixture
def trees(tmp_path):
    _tree(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return tmp_path / "jax", tmp_path / "port"


STEPS = (["scaffold"], ["validate"], ["fix-roboflow"], ["validate"], ["fix-roboflow"],
         ["split", "--val-fraction", "0.3", "--seed", "3"], ["validate"])


def test_every_subcommand_matches_jax(trees, capsys):
    jroot, proot = trees
    for step in STEPS:
        rc_j = jprep.main([step[0], "--data-dir", str(jroot)] + step[1:])
        out_j = capsys.readouterr().out.replace(str(jroot), "<root>")
        rc_p = tprep.main([step[0], "--data-dir", str(proot)] + step[1:])
        out_p = capsys.readouterr().out.replace(str(proot), "<root>")
        assert (rc_p, out_p) == (rc_j, out_j), step
        _same_tree(str(jroot), str(proot))
    assert (proot / "valid" / "_annotations.coco.json").exists()
    assert "PROBLEMS FOUND" in out_p  # the missing file and the orphan stay


def test_split_without_annotations_exits(tmp_path):
    os.makedirs(tmp_path / "train")
    with pytest.raises(SystemExit, match="no _annotations"):
        tprep.main(["split", "--data-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no _annotations"):
        jprep.main(["split", "--data-dir", str(tmp_path)])
