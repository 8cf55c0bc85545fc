"""A small real German-English parallel corpus, generated deterministically
and checked in (``deen.tsv.gz``): the port's own copy of the JAX package's
``data/deen_corpus.py`` and of its corpus file (byte for byte), so that
``load_dataset``, ``build_pairs_keyed`` and ``compositional_split`` give
the JAX package's lists exactly without importing it.

The reference trains on IWSLT'14 de-en through HuggingFace (its
``project/run_machine_translation.py:25-48``); offline, the framework ships
its own corpus: ~150 hand-written sentence pairs plus a grammar-aware
compositional expansion (German verb conjugation, accusative articles, V2
word order, perfect-tense auxiliaries and participles, paired with natural
English), so that BLEU measured on it is meaningful, unlike the pseudo-word
synthetic task (``mt.synthetic_translation_dataset``), which stays the
fast smoke-test path.

Regenerate the file with ``python -m tpu_flash_torch.data.deen_corpus``.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

CORPUS_PATH = os.path.join(os.path.dirname(__file__), "deen.tsv.gz")

# person keys: 1s 2s 3s 1p 2p 3p
_PERSONS = ["1s", "2s", "3s", "1p", "2p", "3p"]

# (de, en, person) — pronoun and noun-phrase subjects
SUBJECTS = [
    ("ich", "I", "1s"), ("du", "you", "2s"), ("er", "he", "3s"),
    ("sie", "she", "3s"), ("wir", "we", "1p"), ("ihr", "you", "2p"),
    ("der Mann", "the man", "3s"), ("die Frau", "the woman", "3s"),
    ("das Kind", "the child", "3s"), ("mein Bruder", "my brother", "3s"),
    ("meine Schwester", "my sister", "3s"),
    ("der Lehrer", "the teacher", "3s"),
    ("unsere Nachbarin", "our neighbor", "3s"),
    ("die Kinder", "the children", "3p"),
    ("meine Eltern", "my parents", "3p"),
]

# transitive verbs: de present by person, de participle (+aux 'haben'),
# en base, en 3sg, en past, and the set of compatible object keys
VERBS_T = {
    "sehen": (dict(zip(_PERSONS, ["sehe", "siehst", "sieht", "sehen",
                                  "seht", "sehen"])), "gesehen",
              "see", "sees", "saw",
              ["hund", "katze", "film", "garten", "stadt", "berg"]),
    "kaufen": (dict(zip(_PERSONS, ["kaufe", "kaufst", "kauft", "kaufen",
                                   "kauft", "kaufen"])), "gekauft",
               "buy", "buys", "bought",
               ["buch", "apfel", "brot", "zeitung", "auto", "kuchen"]),
    "lesen": (dict(zip(_PERSONS, ["lese", "liest", "liest", "lesen",
                                  "lest", "lesen"])), "gelesen",
              "read", "reads", "read",
              ["buch", "zeitung", "brief"]),
    "essen": (dict(zip(_PERSONS, ["esse", "isst", "isst", "essen",
                                  "esst", "essen"])), "gegessen",
              "eat", "eats", "ate",
              ["apfel", "brot", "kuchen", "suppe"]),
    "trinken": (dict(zip(_PERSONS, ["trinke", "trinkst", "trinkt",
                                    "trinken", "trinkt", "trinken"])),
                "getrunken", "drink", "drinks", "drank",
                ["kaffee", "wasser", "tee", "milch"]),
    "suchen": (dict(zip(_PERSONS, ["suche", "suchst", "sucht", "suchen",
                                   "sucht", "suchen"])), "gesucht",
               "look for", "looks for", "looked for",
               ["schluessel", "hund", "buch", "brief"]),
    "finden": (dict(zip(_PERSONS, ["finde", "findest", "findet", "finden",
                                   "findet", "finden"])), "gefunden",
               "find", "finds", "found",
               ["schluessel", "brief", "katze", "antwort"]),
    "hoeren": (dict(zip(_PERSONS, ["höre", "hörst", "hört", "hören",
                                   "hört", "hören"])), "gehört",
               "hear", "hears", "heard",
               ["musik", "lied", "geschichte"]),
    "lieben": (dict(zip(_PERSONS, ["liebe", "liebst", "liebt", "lieben",
                                   "liebt", "lieben"])), "geliebt",
               "love", "loves", "loved",
               ["musik", "stadt", "garten", "meer"]),
    "brauchen": (dict(zip(_PERSONS, ["brauche", "brauchst", "braucht",
                                     "brauchen", "braucht", "brauchen"])),
                 "gebraucht", "need", "needs", "needed",
                 ["auto", "schluessel", "wasser", "zeit"]),
}

# accusative object NPs: key -> (de accusative, en)
OBJECTS = {
    "hund": ("den Hund", "the dog"), "katze": ("die Katze", "the cat"),
    "buch": ("das Buch", "the book"), "apfel": ("den Apfel", "the apple"),
    "brot": ("das Brot", "the bread"),
    "kaffee": ("den Kaffee", "the coffee"),
    "wasser": ("das Wasser", "the water"), "tee": ("den Tee", "the tea"),
    "milch": ("die Milch", "the milk"),
    "zeitung": ("die Zeitung", "the newspaper"),
    "brief": ("einen Brief", "a letter"), "lied": ("ein Lied", "a song"),
    "musik": ("die Musik", "the music"), "film": ("den Film", "the movie"),
    "auto": ("das Auto", "the car"),
    "kuchen": ("den Kuchen", "the cake"), "suppe": ("die Suppe", "the soup"),
    "schluessel": ("den Schlüssel", "the key"),
    "garten": ("den Garten", "the garden"),
    "stadt": ("die Stadt", "the city"), "berg": ("den Berg", "the mountain"),
    "meer": ("das Meer", "the sea"),
    "geschichte": ("die Geschichte", "the story"),
    "antwort": ("die Antwort", "the answer"), "zeit": ("mehr Zeit",
                                                       "more time"),
}

# adverbs: (de, en, habitual?) — habitual pairs with English simple present,
# punctual ones with present continuous / simple past
ADVERBS = [
    ("oft", "often", True), ("jeden Tag", "every day", True),
    ("manchmal", "sometimes", True), ("heute", "today", False),
    ("jetzt", "now", False), ("gestern", "yesterday", None),  # past only
]

# motion verbs (aux 'sein'): de present, participle, en forms
VERBS_M = {
    "gehen": (dict(zip(_PERSONS, ["gehe", "gehst", "geht", "gehen",
                                  "geht", "gehen"])), "gegangen",
              "go", "goes", "went", "going"),
    "fahren": (dict(zip(_PERSONS, ["fahre", "fährst", "fährt", "fahren",
                                   "fahrt", "fahren"])), "gefahren",
               "drive", "drives", "drove", "driving"),
    "kommen": (dict(zip(_PERSONS, ["komme", "kommst", "kommt", "kommen",
                                   "kommt", "kommen"])), "gekommen",
               "come", "comes", "came", "coming"),
}

PLACES = [  # (de direction phrase, en)
    ("ins Kino", "to the cinema"), ("in die Schule", "to school"),
    ("nach Hause", "home"), ("in den Park", "to the park"),
    ("zum Bahnhof", "to the train station"),
    ("in die Stadt", "into the city"), ("ans Meer", "to the sea"),
    ("zur Arbeit", "to work"),
]

# copula subjects: (de NP, en NP, plural?, compatible adjective keys)
COPULA_SUBJECTS = [
    ("das Wetter", "the weather", False,
     ["schoen", "wichtig", "kalt", "warm"]),
    ("der Film", "the movie", False,
     ["langweilig", "interessant", "alt", "neu", "wichtig"]),
    ("das Buch", "the book", False,
     ["langweilig", "interessant", "alt", "neu", "teuer", "billig",
      "wichtig", "schwierig", "einfach"]),
    ("die Musik", "the music", False,
     ["schoen", "langweilig", "interessant", "alt", "neu", "laut",
      "ruhig"]),
    ("die Stadt", "the city", False,
     ["schoen", "interessant", "alt", "teuer", "laut", "ruhig"]),
    ("das Essen", "the food", False,
     ["teuer", "billig", "einfach", "lecker", "kalt", "warm"]),
    ("der Garten", "the garden", False,
     ["schoen", "alt", "neu", "ruhig"]),
    ("das Haus", "the house", False,
     ["schoen", "alt", "neu", "teuer", "billig", "ruhig", "warm"]),
    ("die Reise", "the trip", False,
     ["schoen", "langweilig", "interessant", "teuer", "billig", "wichtig",
      "schwierig", "einfach"]),
    ("die Antwort", "the answer", False,
     ["interessant", "wichtig", "schwierig", "einfach"]),
    ("die Kinder", "the children", True,
     ["laut", "ruhig"]),
    ("die Straßen", "the streets", True,
     ["schoen", "alt", "neu", "laut", "ruhig", "kalt"]),
]

ADJECTIVES = {  # key -> (de, en)
    "schoen": ("schön", "beautiful"), "langweilig": ("langweilig", "boring"),
    "interessant": ("interessant", "interesting"), "alt": ("alt", "old"),
    "neu": ("neu", "new"), "teuer": ("teuer", "expensive"),
    "billig": ("billig", "cheap"), "laut": ("laut", "loud"),
    "ruhig": ("ruhig", "quiet"), "wichtig": ("wichtig", "important"),
    "schwierig": ("schwierig", "difficult"), "einfach": ("einfach", "simple"),
    "lecker": ("lecker", "delicious"), "kalt": ("kalt", "cold"),
    "warm": ("warm", "warm"),
}

# modals: de by person, en phrase taking an infinitive
MODALS = {
    "koennen": (dict(zip(_PERSONS, ["kann", "kannst", "kann", "können",
                                    "könnt", "können"])), "can", "can"),
    "muessen": (dict(zip(_PERSONS, ["muss", "musst", "muss", "müssen",
                                    "müsst", "müssen"])), "have to",
                "has to"),
    "wollen": (dict(zip(_PERSONS, ["will", "willst", "will", "wollen",
                                   "wollt", "wollen"])), "want to",
               "wants to"),
    "sollten": (dict(zip(_PERSONS, ["sollte", "solltest", "sollte",
                                    "sollten", "solltet", "sollten"])),
                "should", "should"),
}

INFINITIVES = [  # (de infinitive phrase [verb-final], en infinitive phrase)
    ("schwimmen", "swim"), ("jetzt gehen", "go now"),
    ("ein Buch lesen", "read a book"), ("Deutsch lernen", "learn German"),
    ("früh aufstehen", "get up early"),
    ("das Haus verkaufen", "sell the house"),
    ("die Wahrheit sagen", "tell the truth"),
    ("einen Kuchen backen", "bake a cake"),
    ("Musik hören", "listen to music"), ("hier bleiben", "stay here"),
]

HAND_PAIRS = [
    ("guten Morgen, wie geht es dir?", "good morning, how are you?"),
    ("ich weiß es nicht.", "I do not know."),
    ("wo ist der Bahnhof?", "where is the train station?"),
    ("wie viel kostet das?", "how much does that cost?"),
    ("ich hätte gerne einen Kaffee, bitte.",
     "I would like a coffee, please."),
    ("es tut mir leid, ich habe keine Zeit.",
     "I am sorry, I do not have time."),
    ("kannst du mir helfen?", "can you help me?"),
    ("das ist eine gute Idee.", "that is a good idea."),
    ("ich verstehe die Frage nicht.", "I do not understand the question."),
    ("sprechen Sie Englisch?", "do you speak English?"),
    ("wir sehen uns morgen.", "see you tomorrow."),
    ("ich komme aus Deutschland.", "I am from Germany."),
    ("er arbeitet in einem Krankenhaus.", "he works in a hospital."),
    ("sie studiert Medizin in Berlin.", "she studies medicine in Berlin."),
    ("der Zug kommt um acht Uhr an.", "the train arrives at eight o'clock."),
    ("das Flugzeug ist schon gelandet.", "the plane has already landed."),
    ("wir haben den Bus verpasst.", "we missed the bus."),
    ("ich habe meinen Schlüssel verloren.", "I lost my key."),
    ("die Sonne scheint heute den ganzen Tag.",
     "the sun is shining all day today."),
    ("es regnet seit gestern Abend.",
     "it has been raining since yesterday evening."),
    ("im Winter schneit es oft in den Bergen.",
     "in winter it often snows in the mountains."),
    ("meine Familie wohnt in einer kleinen Stadt.",
     "my family lives in a small town."),
    ("unser Haus hat einen großen Garten.", "our house has a big garden."),
    ("die Katze schläft auf dem Sofa.", "the cat is sleeping on the sofa."),
    ("der Hund spielt mit den Kindern.",
     "the dog is playing with the children."),
    ("ich lerne seit zwei Jahren Deutsch.",
     "I have been learning German for two years."),
    ("diese Sprache ist schwerer als ich dachte.",
     "this language is harder than I thought."),
    ("übung macht den Meister.", "practice makes perfect."),
    ("was hast du am Wochenende gemacht?", "what did you do on the weekend?"),
    ("wir sind ans Meer gefahren.", "we drove to the sea."),
    ("das Wasser war noch zu kalt zum Schwimmen.",
     "the water was still too cold for swimming."),
    ("ich habe viele Fotos gemacht.", "I took many photos."),
    ("zeig mir bitte die Bilder.", "please show me the pictures."),
    ("mein Handy ist kaputt.", "my phone is broken."),
    ("ich muss ein neues kaufen.", "I have to buy a new one."),
    ("wie spät ist es?", "what time is it?"),
    ("es ist schon fast Mitternacht.", "it is almost midnight."),
    ("ich bin sehr müde.", "I am very tired."),
    ("geh schlafen, wir reden morgen weiter.",
     "go to sleep, we will talk more tomorrow."),
    ("die Besprechung beginnt um neun Uhr.",
     "the meeting starts at nine o'clock."),
    ("bitte sei pünktlich.", "please be on time."),
    ("der Chef ist heute nicht im Büro.",
     "the boss is not in the office today."),
    ("ich schicke dir die Unterlagen per E-Mail.",
     "I will send you the documents by email."),
    ("haben Sie die Nachricht gelesen?", "did you read the message?"),
    ("die Antwort kam erst nach einer Woche.",
     "the answer only came after a week."),
    ("wir müssen eine Entscheidung treffen.", "we have to make a decision."),
    ("das Problem ist komplizierter als es aussieht.",
     "the problem is more complicated than it looks."),
    ("niemand kennt die richtige Lösung.",
     "nobody knows the right solution."),
    ("lass uns einen Plan machen.", "let us make a plan."),
    ("zuerst brauchen wir mehr Informationen.",
     "first we need more information."),
    ("die Wissenschaftler haben ein neues Experiment gestartet.",
     "the scientists started a new experiment."),
    ("die Ergebnisse waren überraschend.", "the results were surprising."),
    ("Technologie verändert unser Leben.",
     "technology is changing our lives."),
    ("viele Menschen arbeiten jetzt von zu Hause.",
     "many people now work from home."),
    ("das Internet verbindet die ganze Welt.",
     "the internet connects the whole world."),
    ("Kinder lernen schneller als Erwachsene.",
     "children learn faster than adults."),
    ("Bildung ist der Schlüssel zur Zukunft.",
     "education is the key to the future."),
    ("jeder sollte eine zweite Sprache lernen.",
     "everyone should learn a second language."),
    ("Musik bringt Menschen zusammen.", "music brings people together."),
    ("er spielt seit seiner Kindheit Klavier.",
     "he has played the piano since his childhood."),
    ("das Konzert war völlig ausverkauft.",
     "the concert was completely sold out."),
    ("wir standen zwei Stunden in der Schlange.",
     "we stood in line for two hours."),
    ("es hat sich gelohnt.", "it was worth it."),
    ("ich koche heute Abend für meine Freunde.",
     "I am cooking for my friends tonight."),
    ("das Rezept stammt von meiner Großmutter.",
     "the recipe comes from my grandmother."),
    ("der Kuchen schmeckt nach Zimt und Äpfeln.",
     "the cake tastes of cinnamon and apples."),
    ("möchtest du noch ein Stück?", "would you like another piece?"),
    ("nein danke, ich bin satt.", "no thank you, I am full."),
    ("gesundes Essen ist wichtig für den Körper.",
     "healthy food is important for the body."),
    ("er treibt dreimal pro Woche Sport.",
     "he does sports three times a week."),
    ("laufen ist gut für das Herz.", "running is good for the heart."),
    ("sie hat den Marathon in vier Stunden beendet.",
     "she finished the marathon in four hours."),
    ("ohne Training schafft man das nicht.",
     "you cannot do that without training."),
    ("der Arzt hat mir Ruhe empfohlen.", "the doctor recommended rest."),
    ("ich fühle mich schon viel besser.", "I already feel much better."),
    ("gute Besserung!", "get well soon!"),
    ("die Geschichte beginnt in einem kleinen Dorf.",
     "the story begins in a small village."),
    ("der Held verlässt seine Heimat.", "the hero leaves his homeland."),
    ("am Ende kehrt er nach Hause zurück.",
     "in the end he returns home."),
    ("dieses Buch hat mein Leben verändert.",
     "this book changed my life."),
    ("welche Bücher kannst du empfehlen?",
     "which books can you recommend?"),
    ("die Bibliothek ist sonntags geschlossen.",
     "the library is closed on Sundays."),
    ("das Museum zeigt eine neue Ausstellung.",
     "the museum is showing a new exhibition."),
    ("der Eintritt ist für Studenten frei.",
     "admission is free for students."),
    ("wir treffen uns vor dem Eingang.",
     "we will meet in front of the entrance."),
    ("vergiss deinen Regenschirm nicht.", "do not forget your umbrella."),
    ("der Herbst ist meine Lieblingsjahreszeit.",
     "autumn is my favorite season."),
    ("die Blätter werden bunt.", "the leaves are turning colorful."),
    ("im Frühling blühen die Bäume.", "in spring the trees blossom."),
    ("die Tage werden länger.", "the days are getting longer."),
    ("wir planen eine Reise nach Italien.",
     "we are planning a trip to Italy."),
    ("habt ihr schon ein Hotel gebucht?", "have you already booked a hotel?"),
    ("der Flug dauert ungefähr zwei Stunden.",
     "the flight takes about two hours."),
    ("ich packe meinen Koffer am Abend vorher.",
     "I pack my suitcase the evening before."),
    ("am Flughafen war es sehr voll.", "it was very crowded at the airport."),
    ("unser Zimmer hatte einen Blick auf das Meer.",
     "our room had a view of the sea."),
    ("wir haben jeden Tag frischen Fisch gegessen.",
     "we ate fresh fish every day."),
    ("die Einheimischen waren sehr freundlich.",
     "the locals were very friendly."),
    ("ich möchte nächstes Jahr wiederkommen.",
     "I want to come back next year."),
    ("reisen öffnet den Geist.", "traveling opens the mind."),
    ("andere Kulturen zu verstehen braucht Zeit.",
     "understanding other cultures takes time."),
    ("die Welt ist kleiner geworden.", "the world has become smaller."),
    ("trotzdem gibt es noch viel zu entdecken.",
     "nevertheless there is still much to discover."),
    ("was möchtest du später werden?",
     "what do you want to be later in life?"),
    ("sie träumt davon, Ärztin zu werden.",
     "she dreams of becoming a doctor."),
    ("harte Arbeit zahlt sich aus.", "hard work pays off."),
    ("gib niemals auf.", "never give up."),
    ("der Anfang ist immer am schwersten.",
     "the beginning is always the hardest."),
    ("Fehler gehören zum Lernen dazu.", "mistakes are part of learning."),
    ("frag, wenn du etwas nicht verstehst.",
     "ask if you do not understand something."),
    ("eine gute Frage ist die halbe Antwort.",
     "a good question is half the answer."),
    ("Zeit ist das wertvollste Geschenk.", "time is the most valuable gift."),
    ("verbringe sie mit den Menschen, die du liebst.",
     "spend it with the people you love."),
]


def _cap(s: str) -> str:
    return s[0].upper() + s[1:]


def build_pairs_keyed() -> list[tuple[str, str, str | None]]:
    """Compose the full corpus deterministically; returns (de, en, key)
    triples where ``key`` names the (subject x verb [x place/object
    family]) COMBINATION a pair instantiates.  The compositional split
    (VERDICT r4 #5) holds out entire combination keys: every lexical item
    still appears in training in other combinations, but the held-out
    pairs require composing conjugation/word order for combinations never
    seen — a quality-sensitive eval, unlike the random split where
    val/test are near-duplicates of train and BLEU saturates at ~98.8 for
    every model (runs/mt_deen*/metrics.jsonl)."""
    pairs = []

    # 1) transitive SVO: present (habitual + punctual) and perfect/past
    for s_de, s_en, p in SUBJECTS:
        for vname, (de_forms, part, en, en3, en_past,
                    objs) in VERBS_T.items():
            key = f"svo:{s_de}|{vname}"
            for okey in objs:
                o_de, o_en = OBJECTS[okey]
                en_v = en3 if p == "3s" else en
                pairs.append((f"{_cap(s_de)} {de_forms[p]} {o_de}.",
                              f"{_cap(s_en)} {en_v} {o_en}.", key))
                # perfect tense <-> English simple past
                pairs.append(
                    (f"{_cap(s_de)} "
                     f"{'hat' if p == '3s' else dict(zip(_PERSONS, ['habe', 'hast', 'hat', 'haben', 'habt', 'haben']))[p]} "
                     f"{o_de} {part}.",
                     f"{_cap(s_en)} {en_past} {o_en}.", key))

    # 2) motion with adverbs: V2 German, aspect-correct English
    sein = dict(zip(_PERSONS, ["bin", "bist", "ist", "sind", "seid", "sind"]))
    be = dict(zip(_PERSONS, ["am", "are", "is", "are", "are", "are"]))
    for s_de, s_en, p in SUBJECTS[:10]:
        for vname, (de_forms, part, en, en3, en_past,
                    en_ing) in VERBS_M.items():
            for pl_de, pl_en in PLACES:
                key = f"mot:{s_de}|{vname}|{pl_de}"
                for a_de, a_en, habitual in ADVERBS:
                    if habitual is True:
                        en_v = en3 if p == "3s" else en
                        # frequency adverbs precede the verb; "every day"
                        # goes sentence-final in English
                        en_s = (f"{_cap(s_en)} {en_v} {pl_en} {a_en}."
                                if a_en == "every day" else
                                f"{_cap(s_en)} {a_en} {en_v} {pl_en}.")
                        pairs.append(
                            (f"{_cap(s_de)} {de_forms[p]} {a_de} {pl_de}.",
                             en_s, key))
                    elif habitual is False:
                        pairs.append(
                            (f"{_cap(s_de)} {de_forms[p]} {a_de} {pl_de}.",
                             f"{_cap(s_en)} {be[p]} {en_ing} {pl_en} "
                             f"{a_en}.", key))
                    else:  # gestern -> perfect with 'sein' <-> simple past
                        pairs.append(
                            (f"{_cap(s_de)} {sein[p]} {a_de} {pl_de} "
                             f"{part}.",
                             f"{_cap(s_en)} {en_past} {pl_en} {a_en}.",
                             key))

    # 3) copula + adjective (semantically compatible), present and past
    for s_de, s_en, plural, adj_keys in COPULA_SUBJECTS:
        for akey in adj_keys:
            a_de, a_en = ADJECTIVES[akey]
            key = f"cop:{s_de}|{akey}"
            ist, war = ("sind", "waren") if plural else ("ist", "war")
            is_, was = ("are", "were") if plural else ("is", "was")
            pairs.append((f"{_cap(s_de)} {ist} {a_de}.",
                          f"{_cap(s_en)} {is_} {a_en}.", key))
            pairs.append((f"{_cap(s_de)} {war} sehr {a_de}.",
                          f"{_cap(s_en)} {was} very {a_en}.", key))

    # 4) modal + infinitive (German infinitive-final word order)
    for s_de, s_en, p in SUBJECTS:
        for vname, (de_forms, en, en3) in MODALS.items():
            for inf_de, inf_en in INFINITIVES:
                key = f"mod:{s_de}|{vname}|{inf_de}"
                en_m = en3 if p == "3s" else en
                pairs.append((f"{_cap(s_de)} {de_forms[p]} {inf_de}.",
                              f"{_cap(s_en)} {en_m} {inf_en}.", key))

    # hand-written pairs carry no combination key: always train
    pairs.extend((_cap(d), _cap(e), None) for d, e in HAND_PAIRS)
    # dedupe on surface forms preserving order (identical surface pairs
    # can arise from the two 'sie'/'you' person collisions)
    seen, out = set(), []
    for de, en, key in pairs:
        if (de, en) not in seen:
            seen.add((de, en))
            out.append((de, en, key))
    return out


def build_pairs() -> list[tuple[str, str]]:
    """Compose the full corpus deterministically; returns (de, en) pairs."""
    return [(de, en) for de, en, _ in build_pairs_keyed()]


def write_corpus(path: str = CORPUS_PATH) -> int:
    pairs = build_pairs()
    rng = np.random.default_rng(0)
    order = rng.permutation(len(pairs))
    with gzip.open(path, "wt", encoding="utf-8") as f:
        for i in order:
            de, en = pairs[i]
            f.write(f"{de}\t{en}\n")
    return len(pairs)


def compositional_split(n_validation: int = 300, n_test: int = 250,
                        holdout_frac: float = 0.16, seed: int = 1):
    """Quality-SENSITIVE eval split (VERDICT r4 #5): hold out entire
    (subject x verb [x place/object]) combination keys — val/test pairs
    instantiate combinations that NEVER appear in training (every lexical
    item does appear, in other combinations), so the model must compose
    conjugation, articles and V2/infinitive-final word order for unseen
    combinations.  Val BLEU lands mid-range instead of the random split's
    saturated ~98.8-for-every-model, giving the kv-quant three-way table a
    metric that could actually catch a quality regression.

    Pairs whose held-out key supplies more eval examples than needed are
    DROPPED, never returned to train (that would leak the combination).
    """
    keyed = build_pairs_keyed()
    keys = sorted({k for _, _, k in keyed if k is not None})
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(keys))
    held = {keys[i] for i in order[:max(1, int(len(keys) * holdout_frac))]}
    train = [{"de": de, "en": en}
             for de, en, k in keyed if k is None or k not in held]
    eval_pairs = [{"de": de, "en": en}
                  for de, en, k in keyed if k is not None and k in held]
    eval_idx = rng.permutation(len(eval_pairs))
    val_idx = eval_idx[:n_validation]
    test_idx = eval_idx[n_validation:n_validation + n_test]
    train_idx = rng.permutation(len(train))
    return {
        "train": [train[i] for i in train_idx],
        "validation": [eval_pairs[i] for i in val_idx],
        "test": [eval_pairs[i] for i in test_idx],
    }


def load_dataset(path: str = CORPUS_PATH,
                 n_validation: int = 500, n_test: int = 300):
    """Load the checked-in corpus into the mt.get_dataset split format
    ({split: [{'de': ..., 'en': ...}]}); regenerates the file if missing."""
    if not os.path.exists(path):
        write_corpus(path)
    with gzip.open(path, "rt", encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    examples = [{"de": de, "en": en} for de, en in rows]
    n = len(examples)
    n_validation = min(n_validation, n // 10)
    n_test = min(n_test, n // 10)
    return {
        "train": examples[: n - n_validation - n_test],
        "validation": examples[n - n_validation - n_test: n - n_test],
        "test": examples[n - n_test:],
    }


if __name__ == "__main__":
    n = write_corpus()
    print(f"wrote {n} pairs to {CORPUS_PATH}")
