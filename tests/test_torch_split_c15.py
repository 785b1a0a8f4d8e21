"""ROADMAP.md C15: the split pickles appear whole.

The ranks of a data-parallel world build the dataset split at once
(``Aff2CompDataset._load_split``: a rank that finds the pickle reads it,
one that does not builds and saves it). Saved in place, a rank could find
the file while another was still writing it and read it half written
(``EOFError``, seen in test_torch_multiproc.py under a loaded machine).
``split.create_dataset_split`` writes each pickle under a name of its own
and renames it, so the split's name never shows a partial file.
"""
import os
import pickle
import re

from auformer_torch.data import split


def test_split_pickles_appear_whole_c15(tmp_path, monkeypatch):
    real, written = pickle.dump, []

    def dump(obj, f, *args, **kwargs):
        final = re.sub(r"\.\d+\.tmp$", "", f.name)
        written.append(os.path.basename(final))
        assert not os.path.exists(final), f"{final} visible while written"
        return real(obj, f, *args, **kwargs)

    monkeypatch.setattr(pickle, "dump", dump)
    out = split.create_dataset_split(str(tmp_path), save_dir=str(tmp_path),
                                     videos=[])
    assert len(written) == 2 * len(split.TASKS)
    for name in written:
        with open(tmp_path / name, "rb") as f:
            assert set(pickle.load(f)) == set(out[split.TASKS[0]])
    assert not list(tmp_path.glob("*.tmp"))
