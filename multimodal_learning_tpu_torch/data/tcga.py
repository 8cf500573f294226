"""TCGA-GBMLGG raw CSV pipeline.

The port's own copy of ``multimodal_learning_tpu/data/tcga.py``, in pandas;
library-level: no module of the port imports it.

Reference ``MICCAI-2022/utils.py:432-540`` (= ``core/utils_data.py:46-118``):
joins ``all_dataset.csv`` with ``grade_data.csv``, optionally merges RNAseq
z-scores, imputes missing genomics with column medians, drops or imputes
missing histology, shifts Grade by -2, integer-codes subtypes, adds the
histomolecular subtype, and flips ``censored`` (so 1 = event observed).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import pandas as pd

MS2INT = {"Missing": -1, "IDHwt": 0, "IDHmut-non-codel": 1,
          "IDHmut-codel": 2}
HS2INT = {"Missing": -1, "astrocytoma": 0, "oligoastrocytoma": 1,
          "oligodendroglioma": 2, "glioblastoma": 3}
METADATA = ["Histology", "Grade", "Molecular subtype", "TCGA ID",
            "censored", "Survival months"]


def add_histomolecular_subtype(data: pd.DataFrame) -> pd.DataFrame:
    """IDH/1p19q + histology -> {idhwt_ATC, idhmut_ATC, ODG}
    (``utils.py:432-447``)."""
    out = data.copy()
    # object dtype: modern pandas refuses string assignment into the
    # reference's float np.ones initialiser (utils.py:438)
    out.insert(loc=0, column="Histomolecular subtype",
               value=np.array([1.0] * len(data), dtype=object))
    idhwt_atc = (data["Molecular subtype"] == 0) & (
        (data["Histology"] == 0) | (data["Histology"] == 3))
    out.loc[idhwt_atc, "Histomolecular subtype"] = "idhwt_ATC"
    idhmut_atc = (data["Molecular subtype"] == 1) & (
        (data["Histology"] == 0) | (data["Histology"] == 3))
    out.loc[idhmut_atc, "Histomolecular subtype"] = "idhmut_ATC"
    odg = (data["Molecular subtype"] == 2) & (data["Histology"] == 2)
    out.loc[odg, "Histomolecular subtype"] = "ODG"
    return out


def change_histomolecular_subtype(data: pd.DataFrame) -> pd.DataFrame:
    """Re-derive ``Histomolecular subtype`` from the int-coded columns
    (``core/utils_data.py:27-44``): drop the stale column and re-subtype.
    The reference's aggregation flow applies this to the pooled per-patient
    frame before the subtype-stratified KM plots
    (``core/utils_analysis.py:567``)."""
    return add_histomolecular_subtype(
        data.drop(columns=["Histomolecular subtype"]))


def get_clean_all_dataset(dataroot: str = "./data/TCGA_GBMLGG/",
                          ignore_missing_moltype: bool = False,
                          ignore_missing_histype: bool = False,
                          use_rnaseq: bool = False
                          ) -> Tuple[list, pd.DataFrame]:
    """reference ``getCleanAllDataset`` (``utils.py:469-535``)."""
    metadata = list(METADATA)
    all_dataset = pd.read_csv(
        os.path.join(dataroot, "all_dataset.csv")).drop("indexes", axis=1)
    all_dataset.index = all_dataset["TCGA ID"]

    all_grade = pd.read_csv(os.path.join(dataroot, "grade_data.csv"))
    all_grade["Histology"] = all_grade["Histology"].str.replace(
        "astrocytoma (glioblastoma)", "glioblastoma", regex=False)
    all_grade.index = all_grade["TCGA ID"]

    all_dataset = all_dataset.join(
        all_grade[["Histology", "Grade", "Molecular subtype"]], how="inner")
    cols = all_dataset.columns.tolist()
    all_dataset = all_dataset[cols[-3:] + cols[:-3]]

    if use_rnaseq:
        gbm = pd.read_csv(os.path.join(
            dataroot, "mRNA_Expression_z-Scores_RNA_Seq_RSEM.txt"),
            sep="\t", skiprows=1, index_col=0)
        lgg = pd.read_csv(os.path.join(
            dataroot, "mRNA_Expression_Zscores_RSEM.txt"),
            sep="\t", skiprows=1, index_col=0)
        gbm = gbm[gbm.columns[~gbm.isnull().all()]]
        lgg = lgg[lgg.columns[~lgg.isnull().all()]]
        rnaseq = gbm.join(lgg, how="inner").T.dropna(axis=1)
        rnaseq.columns = [g + "_rnaseq" for g in rnaseq.columns]
        rnaseq.index = [p[:12] for p in rnaseq.index]
        rnaseq = rnaseq.iloc[~rnaseq.index.duplicated()]
        rnaseq.index.name = "TCGA ID"
        all_dataset = all_dataset.join(rnaseq, how="inner")

    if ignore_missing_moltype:
        all_dataset = all_dataset[~all_dataset["Molecular subtype"].isna()]
    all_dataset["Molecular subtype"] = \
        all_dataset["Molecular subtype"].fillna("Missing")
    for col in all_dataset.drop(metadata, axis=1).columns:
        all_dataset[col] = all_dataset[col].fillna(all_dataset[col].median())

    if ignore_missing_histype:
        all_dataset = all_dataset[~all_dataset["Histology"].isna()]
    else:
        all_dataset["Grade"] = all_dataset["Grade"].fillna(1)
        all_dataset["Histology"] = all_dataset["Histology"].fillna("Missing")
    all_dataset["Grade"] = all_dataset["Grade"] - 2

    all_dataset["Molecular subtype"] = all_dataset["Molecular subtype"].map(
        lambda s: MS2INT.get(s, s))
    all_dataset["Histology"] = all_dataset["Histology"].map(
        lambda s: HS2INT.get(s, s))
    all_dataset = add_histomolecular_subtype(all_dataset)
    metadata.append("Histomolecular subtype")
    all_dataset["censored"] = 1 - all_dataset["censored"]
    return metadata, all_dataset


def get_clean_kirc(dataroot: str = "./", rnaseq_cutoff="all",
                   cnv_cutoff: float = 7.0, mut_cutoff=5.0) -> pd.DataFrame:
    """TCGA-KIRC omic-feature recipe (``core/utils_data.py:120-165`` —
    dead code in the reference: no call sites; the KIRC analysis functions
    consume pre-built pickles).

    Joins per-sample RNAseq z-scores restricted to the DEG list, CNV calls
    restricted by alteration frequency, and per-gene mutation indicators,
    all keyed by the clinical table's sample index.  ``rnaseq_cutoff`` and
    ``mut_cutoff`` are accepted-but-unused exactly like the reference
    (``:136`` computes the former and never applies either).  Two
    documented fixes of latent crashes in the reference's own text
    (PARITY.md deviations; ``tests/test_reference_parity_tcga.py`` proves
    the reference raises where these fire):

    - mutation rows: the reference's ``mut.index[:-3]`` (``:160``) is a
      *positional* slice, so its boolean mask is 3 short and ``.loc``
      raises whenever any ``muts/*.tsv`` exists; the evident intent is
      stripping the ``-0X`` sample suffix to a Patient ID —
      ``index.str[:-3]`` here.
    - mutation gene names: the reference's ``.rstrip('.tsv')`` (``:159``)
      strips a character *class*, not a suffix — a theoretical hazard for
      gene names ending in lowercase t/s/v/'.' (``rstrip`` is
      case-sensitive, so the usual uppercase symbols like ``MET`` are in
      practice unaffected); here the exact ``.tsv`` suffix is removed.
    - ``muts/`` files are visited in sorted order (the reference's
      ``os.listdir`` order is filesystem-dependent).
    """
    clinical = pd.read_table(
        os.path.join(dataroot,
                     "kirc_tcga_pan_can_atlas_2018_clinical_data.tsv"),
        index_col=2)
    clinical.index.name = None

    rnaseq = pd.read_table(
        os.path.join(dataroot, "data_RNA_Seq_v2_mRNA_median_Zscores.txt"),
        index_col=0)
    rnaseq = rnaseq[rnaseq.index.notnull()]
    rnaseq = rnaseq.drop(["Entrez_Gene_Id"], axis=1)
    rnaseq.index.name = None
    degs = pd.read_csv(os.path.join(dataroot, "dataDEGs_kirc.csv"),
                       index_col=0)
    degs = degs.sort_values(["PValue", "logFC"], ascending=False)
    rnaseq = rnaseq.loc[rnaseq.index.intersection(degs.index)].T
    rnaseq.columns = [g + "_rnaseq" for g in rnaseq.columns]

    cnv = pd.read_table(os.path.join(dataroot, "data_CNA.txt"), index_col=0)
    cnv = cnv[cnv.index.notnull()]
    cnv = cnv.drop(["Entrez_Gene_Id"], axis=1)
    cnv.index.name = None
    freq = pd.read_table(os.path.join(dataroot, "CNA_Genes.txt"),
                         index_col=0)
    freq = freq[["CNA", "Profiled Samples", "Freq"]]
    freq["Freq"] = freq["Freq"].str.rstrip("%").astype(float)
    if isinstance(cnv_cutoff, str):
        cnv_cutoff = freq.shape[0]
    freq = freq[freq["Freq"] >= cnv_cutoff]
    cnv = cnv.loc[cnv.index.intersection(freq.index)].T
    cnv.columns = [g + "_cnv" for g in cnv.columns]

    mut = clinical[["Patient ID"]].copy()
    muts_dir = os.path.join(dataroot, "muts")
    for tsv in sorted(os.listdir(muts_dir)):
        if tsv.endswith(".tsv"):
            samples = pd.read_table(
                os.path.join(muts_dir, tsv))["Patient ID"]
            # strip the suffix from the whole filename BEFORE splitting so
            # >3-field names (mutated_samples_GENE_v2.tsv) keep their gene
            gene = tsv[:-len(".tsv")].split("_", 2)[2] + "_mut"
            mut[gene] = 0
            mut.loc[mut.index.str[:-3].isin(samples), gene] = 1
    mut = mut.drop(["Patient ID"], axis=1)

    return rnaseq.join(cnv, how="inner").join(mut, how="inner")
