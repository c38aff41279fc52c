"""A configuration's genome and the port's index of it, built on a
checkout's first run of the configuration and read from
portbench/cache/<config>-<digest>/ by every later one. The digest covers
the configuration file and its genome recipe's own file, so a changed
recipe builds afresh and a new recipe leaves every other cache as it is;
the directory's name is fixed by them alone."""

import hashlib
import os
import pickle
import shutil

from portbench.gen import genome as genome_mod

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cache")


def cache_dir(config, config_file, cache=CACHE):
    h = hashlib.sha256()
    for path in (config_file, genome_mod.recipe_file(config["genome"])):
        with open(path, "rb") as f:
            h.update(f.read())
    name = os.path.splitext(os.path.basename(config_file))[0]
    return os.path.join(cache, f"{name}-{h.hexdigest()[:12]}")


def _refs(d):
    with open(os.path.join(d, "genome.pkl"), "rb") as f:
        return pickle.load(f)


def genome_only(config, config_file, cache=CACHE):
    """A configuration's Genome, from the cache where it is there."""
    d = cache_dir(config, config_file, cache)
    if os.path.exists(os.path.join(d, "genome.pkl")):
        return genome_mod.Genome(_refs(d))
    return genome_mod.Genome(genome_mod.make_refs(config["genome"]))


def load(config, config_file, log, cache=CACHE):
    """(Genome, the port's IndexData) of a configuration."""
    from bowtie2_tpu_torch.index.build import build_index_from_refs

    d = cache_dir(config, config_file, cache)
    if not os.path.exists(os.path.join(d, "index.pkl")):
        part = d + ".partial"
        shutil.rmtree(part, ignore_errors=True)
        os.makedirs(part)
        refs = genome_mod.make_refs(config["genome"])
        log(f"genome {config['genome']['recipe']}: {len(refs)} "
            f"reference(s), {sum(c.size for _n, c in refs)} bp made; "
            f"building the index")
        data = build_index_from_refs(refs, large=config["index"]["large"])
        with open(os.path.join(part, "genome.pkl"), "wb") as f:
            pickle.dump(refs, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(part, "index.pkl"), "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.rename(part, d)
        log(f"cache written: {d}")
    genome = genome_mod.Genome(_refs(d))
    with open(os.path.join(d, "index.pkl"), "rb") as f:
        data = pickle.load(f)
    return genome, data
