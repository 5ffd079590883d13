"""Run recording: snapshot code and config into the experiment directory.

Counterpart of ``vdnerf_tpu/io/recording.py`` (the reference's
``file_backup``): the ``general.recording`` conf list names files or
directories, relative to the directory of the running script, whose ``.py``
sources are copied into ``<base_exp_dir>/recording/``, plus the conf with the
command line appended as a comment.
"""

from __future__ import annotations

import os
import sys
from shutil import copyfile


def record_run(base_exp_dir: str, recording_list, conf_path: str) -> None:
    rec_dir = os.path.join(base_exp_dir, "recording")
    os.makedirs(rec_dir, exist_ok=True)
    base_folder = os.path.dirname(os.path.abspath(sys.argv[0])) or "."

    for entry in recording_list or []:
        src = os.path.join(base_folder, entry)
        if os.path.isfile(src):
            if src.endswith(".py"):
                copyfile(src, os.path.join(rec_dir, os.path.basename(src)))
            continue
        if not os.path.isdir(src):
            continue
        dst_dir = os.path.join(rec_dir, os.path.basename(entry.rstrip("/")))
        for root, _dirs, files in os.walk(src):
            rel = os.path.relpath(root, src)
            for fname in files:
                if fname.endswith(".py"):
                    out = os.path.join(dst_dir, rel, fname)
                    os.makedirs(os.path.dirname(out), exist_ok=True)
                    copyfile(os.path.join(root, fname), out)

    if conf_path and os.path.isfile(conf_path):
        out_conf = os.path.join(rec_dir, "config.conf")
        copyfile(conf_path, out_conf)
        with open(out_conf, "a") as f:
            f.write("# " + " ".join(sys.argv) + "\n")
