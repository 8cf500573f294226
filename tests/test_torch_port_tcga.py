"""The port's TCGA CSV cleaning against the JAX package's, on fabricated
tables (the raw TCGA files are not in the repository).

``get_clean_all_dataset`` over the four ``ignore_missing_moltype`` /
``ignore_missing_histype`` cases, with and without the RNAseq join, on the
layout of the GBMLGG tables (every branch of the recipe: jointly missing
molecular triplets, missing histology and grade, the 'astrocytoma
(glioblastoma)' rename, median imputation) and on the miniature pair of
``test_analysis.py``; ``get_clean_kirc`` with and without mutation files;
``change_histomolecular_subtype``.  Frames are compared exactly.
"""
import os

import numpy as np
import pandas as pd
import pytest

from multimodal_learning_tpu.data import tcga as jtcga
from multimodal_learning_tpu_torch.data import tcga


def _fabricate(root, rnaseq=False):
    rng = np.random.default_rng(17)
    n = 24
    ids = [f"TCGA-{i:02d}-{1000 + i}" for i in range(n)]
    omic = {f"gene_{g}": rng.normal(size=n).round(4) for g in range(6)}
    idh = rng.normal(size=n).round(4)
    codel = rng.normal(size=n).round(4)
    missing_mol = [3, 7, 11]
    idh[missing_mol] = np.nan
    codel[missing_mol] = np.nan
    omic["gene_0"][[1, 5]] = np.nan
    pd.DataFrame({
        "indexes": np.arange(n), "TCGA ID": ids, **omic,
        "idh mutation": idh, "codeletion": codel,
        "censored": rng.integers(0, 2, size=n),
        "Survival months": rng.uniform(1, 120, size=n).round(1),
    }).to_csv(f"{root}/all_dataset.csv", index=False)

    hist = rng.choice(["astrocytoma", "oligoastrocytoma",
                       "oligodendroglioma", "astrocytoma (glioblastoma)"],
                      size=n).astype(object)
    grade = rng.choice([2.0, 3.0, 4.0], size=n).astype(object)
    mol = np.array(["IDHwt", "IDHmut-non-codel", "IDHmut-codel"],
                   dtype=object)[rng.integers(0, 3, size=n)]
    mol[missing_mol] = np.nan
    hist[[2, 9]] = np.nan
    grade[[2, 9]] = np.nan
    pd.DataFrame({"TCGA ID": ids, "Histology": hist, "Grade": grade,
                  "Molecular subtype": mol}).to_csv(
        f"{root}/grade_data.csv", index=False)

    if rnaseq:
        genes = [f"G{g}" for g in range(5)]
        for name, part in (("mRNA_Expression_z-Scores_RNA_Seq_RSEM.txt",
                            ids[:14]),
                           ("mRNA_Expression_Zscores_RSEM.txt", ids[14:])):
            cols = [f"{p}-01" for p in part]
            if name.startswith("mRNA_Expression_Zscores"):
                cols[0] = f"{part[0]}-01"
                cols.append(f"{part[0]}-02")      # a duplicated patient
            vals = rng.normal(size=(len(genes), len(cols))).round(3)
            vals[4, 1] = np.nan                    # G4 dropped after .T
            df = pd.DataFrame(vals, index=pd.Index(genes, name="Gene"),
                              columns=cols)
            df["all_nan"] = np.nan                 # dropped column
            with open(f"{root}/{name}", "w") as fh:
                fh.write("# z-scores\n")
                df.to_csv(fh, sep="\t")


def _fabricate_small(root):
    """The miniature pair of ``tests/test_analysis.py``."""
    ids = [f"TCGA-{i:02d}" for i in range(8)]
    pd.DataFrame({
        "indexes": range(8), "TCGA ID": ids,
        "censored": [0, 1, 0, 1, 0, 1, 0, 1],
        "Survival months": np.linspace(5, 80, 8),
        "idh mutation": [1, 0, None, 1, 0, 1, 0, 1],
        "codeletion": [1, 0, None, 0, 0, 1, 0, 1],
        "geneA": [1.0, 2.0, None, 4.0, 5.0, 6.0, 7.0, 8.0],
    }).to_csv(f"{root}/all_dataset.csv", index=False)
    pd.DataFrame({
        "TCGA ID": ids,
        "Histology": ["astrocytoma", "glioblastoma",
                      "astrocytoma (glioblastoma)", "oligodendroglioma",
                      None, "oligoastrocytoma", "astrocytoma",
                      "glioblastoma"],
        "Grade": [2, 4, 4, 3, None, 2, 3, 4],
        "Molecular subtype": ["IDHmut-codel", "IDHwt", None, "IDHmut-codel",
                              "IDHwt", "IDHmut-non-codel", "IDHwt", "IDHwt"],
    }).to_csv(f"{root}/grade_data.csv", index=False)


@pytest.mark.parametrize("layout", ["gbmlgg", "gbmlgg_rnaseq", "small"])
@pytest.mark.parametrize("ignore_mol", [False, True])
@pytest.mark.parametrize("ignore_hist", [False, True])
def test_get_clean_all_dataset_equals_jax(tmp_path, layout, ignore_mol,
                                          ignore_hist):
    if layout == "small":
        _fabricate_small(tmp_path)
    else:
        _fabricate(tmp_path, rnaseq=layout == "gbmlgg_rnaseq")
    kw = dict(dataroot=str(tmp_path), ignore_missing_moltype=ignore_mol,
              ignore_missing_histype=ignore_hist,
              use_rnaseq=layout == "gbmlgg_rnaseq")
    meta, df = tcga.get_clean_all_dataset(**kw)
    jmeta, jdf = jtcga.get_clean_all_dataset(**kw)
    assert meta == jmeta
    pd.testing.assert_frame_equal(df, jdf, check_exact=True)
    assert "Histomolecular subtype" in df.columns
    if layout == "gbmlgg_rnaseq":
        assert "G0_rnaseq" in df.columns and "G4_rnaseq" not in df.columns


def _fabricate_kirc(root, n=6):
    rng = np.random.default_rng(23)
    genes = ["KDR", "MET", "VHL", "PBRM1", "SETD2", "BAP1"]
    samples = [f"TCGA-A3-{1000 + i}-01" for i in range(n)]
    patients = [s[:-3] for s in samples]
    pd.DataFrame({
        "Study ID": ["kirc_tcga"] * n, "Patient ID": patients,
        "Sample ID": samples,
        "Overall Survival Status": rng.choice(["LIVING", "DECEASED"], n),
    }).to_csv(f"{root}/kirc_tcga_pan_can_atlas_2018_clinical_data.tsv",
              sep="\t", index=False)

    def omic_table(name, values):
        df = pd.DataFrame(values, columns=samples)
        df.insert(0, "Entrez_Gene_Id", np.arange(len(df)) + 100)
        df.index = pd.Index(genes + [np.nan], name="Hugo_Symbol")
        df.to_csv(f"{root}/{name}", sep="\t")

    omic_table("data_RNA_Seq_v2_mRNA_median_Zscores.txt",
               rng.normal(size=(len(genes) + 1, n)).round(4))
    omic_table("data_CNA.txt", rng.integers(-2, 3, size=(len(genes) + 1, n)))
    pd.DataFrame({"PValue": [1e-5, 1e-4, 2e-3, 1e-2],
                  "logFC": [2.0, -1.5, 1.1, 0.7]},
                 index=pd.Index(["VHL", "MET", "KDR", "SETD2"],
                                name="gene")).to_csv(
        f"{root}/dataDEGs_kirc.csv")
    pd.DataFrame({"CNA": ["DEL", "AMP", "DEL", "AMP", "DEL", "DEL"],
                  "Profiled Samples": [n] * 6,
                  "Freq": ["2.0%", "10.0%", "30.0%", "8.0%", "5.0%",
                           "12.0%"]},
                 index=pd.Index(genes, name="Gene")).to_csv(
        f"{root}/CNA_Genes.txt", sep="\t")
    os.makedirs(f"{root}/muts", exist_ok=True)
    return patients


@pytest.mark.parametrize("muts", [False, True])
def test_get_clean_kirc_equals_jax(tmp_path, muts):
    patients = _fabricate_kirc(tmp_path)
    if muts:
        for gene, carriers in (("VHL", patients[:3]), ("MET", patients[3:4]),
                               ("KDR_v2", patients[4:])):
            pd.DataFrame({"Patient ID": carriers}).to_csv(
                f"{tmp_path}/muts/mutated_samples_{gene}.tsv", sep="\t",
                index=False)
    got = tcga.get_clean_kirc(dataroot=str(tmp_path))
    pd.testing.assert_frame_equal(
        got, jtcga.get_clean_kirc(dataroot=str(tmp_path)), check_exact=True)
    assert "KDR_cnv" not in got.columns      # 2 % is under the 7 % cut
    if muts:
        assert {"VHL_mut", "MET_mut", "KDR_v2_mut"} <= set(got.columns)
        assert got["VHL_mut"].tolist() == [1, 1, 1, 0, 0, 0]


def test_change_histomolecular_subtype_equals_jax():
    rng = np.random.default_rng(5)
    n = 20
    df = pd.DataFrame({
        "Histomolecular subtype": np.array(["stale"] * n, dtype=object),
        "Molecular subtype": rng.integers(-1, 3, n),
        "Histology": rng.integers(-1, 4, n),
        "Hazard": rng.normal(size=n).round(3)})
    got = tcga.change_histomolecular_subtype(df.copy())
    pd.testing.assert_frame_equal(
        got, jtcga.change_histomolecular_subtype(df.copy()), check_exact=True)
    assert set(got["Histomolecular subtype"]) <= {"idhwt_ATC", "idhmut_ATC",
                                                  "ODG", 1.0}
    assert tcga.MS2INT == jtcga.MS2INT and tcga.HS2INT == jtcga.HS2INT
    assert tcga.METADATA == jtcga.METADATA
